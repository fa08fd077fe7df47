"""Seeded inputs of the benchmark: object meshes, a plain z-buffer renderer,
LM-O-like RGB frames with their detections, and training patches.

Everything here is made from the run's seed on the device, in a few large
calls, and handed unchanged to the program and to the plain reference.
Nothing here imports the program.

The meshes stand in for LM-O's models (which the repository does not
hold): an icosphere deformed by a few seeded low-frequency waves, scaled
to the object's diameter, with smooth seeded vertex colours.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ------------------------------------------------------------------ meshes
def icosphere(level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit icosphere: (V, 3) float32 vertices, (F, 3) int64 faces, outward
    counter-clockwise. ``level`` subdivisions of the icosahedron: 20 * 4**level
    faces."""
    p = (1.0 + 5 ** 0.5) / 2.0
    v = torch.tensor([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                      [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                      [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                     dtype=torch.float64)
    f = torch.tensor([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                      [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    v = v / v.norm(dim=1, keepdim=True)
    for _ in range(level):
        e = torch.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], 1)
        e_sorted = e.sort(-1).values.reshape(-1, 2)
        uniq, inv = torch.unique(e_sorted, dim=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid = mid / mid.norm(dim=1, keepdim=True)
        m = (inv + v.shape[0]).reshape(-1, 3)   # midpoints of edges 01 12 20
        v = torch.cat([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[:, 0], m[:, 1], m[:, 2]
        f = torch.cat([torch.stack([a, ab, ca], 1), torch.stack([b, bc, ab], 1),
                       torch.stack([c, ca, bc], 1), torch.stack([ab, bc, ca], 1)])
    return v.to(torch.float32), f


def make_mesh(gen: torch.Generator, diameter_mm: float, level: int,
              device) -> dict:
    """One seeded object: ``verts`` (V, 3) mm centred near 0, ``faces``,
    ``colors`` (V, 3) in [0, 1]. Its diameter (twice the largest vertex
    norm) is ``diameter_mm``."""
    v, f = icosphere(level)
    v, f = v.to(device), f.to(device)
    u = torch.rand((6, 5), generator=gen, device=device)
    dirs = torch.randn((6, 3), generator=gen, device=device)
    dirs = dirs / dirs.norm(dim=1, keepdim=True) * (1.5 + 1.5 * u[:, 0:1])
    amp = 0.04 + 0.08 * u[:, 1]
    phase = 2 * math.pi * u[:, 2]
    r = 1.0 + (amp * torch.cos(v @ dirs.T + phase)).sum(1)
    aspect = 0.55 + 0.45 * torch.rand(3, generator=gen, device=device)
    verts = v * r[:, None] * aspect
    verts = verts * (diameter_mm / (2.0 * verts.norm(dim=1).max()))
    w = torch.randn((3, 3), generator=gen, device=device) * 2.5
    ph = 2 * math.pi * torch.rand(3, generator=gen, device=device)
    colors = 0.5 + 0.42 * torch.sin(v @ w + ph)
    return {"verts": verts.contiguous(), "faces": f.contiguous(),
            "colors": colors.contiguous()}


def norm_factor(verts: torch.Tensor) -> torch.Tensor:
    """(6,) [scale_xyz, ct_xyz]: the reference's coordinate colour codec,
    per axis the largest distance from the mean and the mean."""
    ct = verts.mean(0)
    return torch.cat([(verts - ct).abs().amax(0), ct])


def random_rotations(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 3, 3) rotations uniform on SO(3) (unit quaternions)."""
    q = torch.randn((n, 4), generator=gen, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], 1).reshape(n, 3, 3)


# ---------------------------------------------------------------- renderer
# z-buffer key: depth in micrometres, then the instance, then the face
_FACE_BITS = 17
_ID_BITS = 20 + _FACE_BITS


def render(meshes: list, inst: list, cam_k: torch.Tensor, n_img: int,
           height: int, width: int) -> dict:
    """Z-buffer render of mesh instances into ``n_img`` images.

    ``inst``: [(image index, mesh index, R (3, 3), t (3,) mm)]. Pixel
    (i, j) has its centre at (u, v) = (j, i). Faces are tested at the pixel
    centres of a stencil over their box; the nearest face wins (ties to the
    lower instance and face). Returns ``inst`` (n, H, W) int64 instance
    index (-1: empty), ``color`` (n, H, W, 3) perspective-correct vertex
    colours, and ``xyz`` (n, H, W, 3) model coordinates (mm) of the visible
    surface."""
    dev = cam_k.device
    fx, fy, cx, cy = cam_k[0, 0], cam_k[1, 1], cam_k[0, 2], cam_k[1, 2]
    big = torch.iinfo(torch.int64).max
    key = torch.full((n_img * height * width,), big, dtype=torch.int64,
                     device=dev)
    tri_cache = []
    for k, (img, mi, R, t) in enumerate(inst):
        m = meshes[mi]
        cam = m["verts"] @ R.T + t
        z = cam[:, 2]
        u = fx * cam[:, 0] / z + cx
        v = fy * cam[:, 1] / z + cy
        f = m["faces"]
        fu, fv, fz = u[f], v[f], z[f]                    # (F, 3)
        tri_cache.append((fu, fv, fz))
        area = ((fu[:, 1] - fu[:, 0]) * (fv[:, 2] - fv[:, 0])
                - (fu[:, 2] - fu[:, 0]) * (fv[:, 1] - fv[:, 0]))
        ok = (area.abs() > 1e-9) & (fz > 1.0).all(1)
        j0 = torch.ceil(fu.amin(1))
        i0 = torch.ceil(fv.amin(1))
        ext = torch.maximum(fu.amax(1) - j0, fv.amax(1) - i0)
        s = int(min(max(float(ext[ok].amax()) + 1, 1.0), 12.0)) \
            if bool(ok.any()) else 1
        d = torch.arange(s, device=dev, dtype=torch.float32)
        pj = (j0[:, None, None] + d[None, None, :]).expand(-1, s, s)
        pi = (i0[:, None, None] + d[None, :, None]).expand(-1, s, s)
        w0, w1, w2 = _bary(fu, fv, area, pj, pi)
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok[:, None, None]
                  & (pj >= 0) & (pj < width) & (pi >= 0) & (pi < height))
        iz = (w0 / fz[:, 0, None, None] + w1 / fz[:, 1, None, None]
              + w2 / fz[:, 2, None, None])
        depth = 1.0 / iz
        gid = (k << _FACE_BITS) + torch.arange(f.shape[0], device=dev)
        kv = ((depth * 1000.0).to(torch.int64) << _ID_BITS) \
            | gid[:, None, None]
        pix = (img * height * width + pi.to(torch.int64) * width
               + pj.to(torch.int64))
        key.scatter_reduce_(0, pix[inside], kv[inside], reduce="amin")
    hit = key != big
    low = key & ((1 << _ID_BITS) - 1)
    k_idx = torch.where(hit, low >> _FACE_BITS, -1)
    f_idx = low & ((1 << _FACE_BITS) - 1)
    out_color = torch.zeros(key.shape + (3,), device=dev)
    out_xyz = torch.zeros(key.shape + (3,), device=dev)
    flat = torch.arange(key.shape[0], device=dev)
    for k, (img, mi, R, t) in enumerate(inst):
        sel = k_idx == k
        if not bool(sel.any()):
            continue
        pix = flat[sel]
        fi = f_idx[sel]
        fu, fv, fz = (x[fi] for x in tri_cache[k])
        rem = pix - img * height * width
        pi = (rem // width).to(torch.float32)
        pj = (rem % width).to(torch.float32)
        area = ((fu[:, 1] - fu[:, 0]) * (fv[:, 2] - fv[:, 0])
                - (fu[:, 2] - fu[:, 0]) * (fv[:, 1] - fv[:, 0]))
        w = torch.stack(_bary(fu, fv, area, pj, pi), 1) / fz   # (P, 3)
        zz = 1.0 / w.sum(1)
        m = meshes[mi]
        fverts = m["faces"][fi]
        out_color[pix] = (w[..., None] * m["colors"][fverts]).sum(1) \
            * zz[:, None]
        out_xyz[pix] = (w[..., None] * m["verts"][fverts]).sum(1) \
            * zz[:, None]
    shp = (n_img, height, width)
    return {"inst": k_idx.reshape(shp),
            "color": out_color.reshape(shp + (3,)),
            "xyz": out_xyz.reshape(shp + (3,))}


def _bary(fu, fv, area, pj, pi):
    """Barycentric weights of pixel centres (pj, pi) in faces (fu, fv)
    (F, 3), broadcast over the trailing stencil axes of pj / pi."""
    ex = (lambda a: a) if pj.dim() == 1 else (lambda a: a[:, None, None])
    a = ex(area)

    def edge(i, j):
        return ((ex(fu[:, j]) - ex(fu[:, i])) * (pi - ex(fv[:, i]))
                - (ex(fv[:, j]) - ex(fv[:, i])) * (pj - ex(fu[:, i])))

    return edge(1, 2) / a, edge(2, 0) / a, edge(0, 1) / a


# -------------------------------------------------------------- backgrounds
def smooth_noise(gen, n: int, height: int, width: int, cell: int,
                 device) -> torch.Tensor:
    """(n, H, W, 3) float in [0, 1]: bilinear-upsampled coarse noise plus a
    little fine grain."""
    ch, cw = height // cell + 2, width // cell + 2
    coarse = torch.rand((n, 3, ch, cw), generator=gen, device=device)
    up = torch.nn.functional.interpolate(coarse, size=(height, width),
                                         mode="bilinear", align_corners=False)
    fine = torch.rand((n, 3, height, width), generator=gen, device=device)
    return (0.85 * up + 0.15 * fine).permute(0, 2, 3, 1).clamp(0, 1)


# ------------------------------------------------------------ serving pool
def build_frames(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The pool of LM-O-like frames a camera cell cycles through.

    The pool is ``pool_blocks`` blocks of ``len(visible_per_frame)``
    frames. A frame shows its count of the configuration's objects, one
    instance each, on a textured background; each block holds the counts
    of ``visible_per_frame`` once, in an order the seed draws, so any run
    of whole blocks, and so every seed's window, serves the same amount of
    work. Returns numpy ``rgb`` (P, H, W, 3) uint8, ``dets`` per frame
    [(obj_id, bbox (4,) int32 [v1, u1, v2, u2], score, visible mask (H, W)
    bool)], each detection's true pose ``truth`` [(R (3, 3), t (3,) mm)],
    the meshes (on ``device``) and each object's (6,) norm factors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    h, w = cfg["camera"]["height"], cfg["camera"]["width"]
    cam_k = camera_matrix(cfg, device)
    objs = cfg["objects"]
    meshes = [make_mesh(gen, o["diameter_mm"], cfg["mesh_level"], device)
              for o in objs]
    block = list(mix["visible_per_frame"])
    counts = [block[i] for _ in range(mix["pool_blocks"])
              for i in rng.permutation(len(block))]
    n_pool = len(counts)
    inst, which = [], []
    cells_u, cells_v = 4, 2
    for fi, n_vis in enumerate(counts):
        chosen = rng.choice(len(objs), size=min(n_vis, len(objs)),
                            replace=False)
        slots = rng.permutation(cells_u * cells_v)[:len(chosen)]
        rots = random_rotations(gen, len(chosen), device)
        for k, (oi, sl) in enumerate(zip(chosen, slots)):
            z = float(rng.uniform(*mix["depth_mm"]))
            pu = (sl % cells_u + 0.5) / cells_u * (w - 160) + 80 \
                + rng.uniform(-25, 25)
            pv = (sl // cells_u + 0.5) / cells_v * (h - 140) + 70 \
                + rng.uniform(-25, 25)
            t = torch.tensor([(pu - float(cam_k[0, 2])) * z
                              / float(cam_k[0, 0]),
                              (pv - float(cam_k[1, 2])) * z
                              / float(cam_k[1, 1]), z],
                             dtype=torch.float32, device=device)
            inst.append((fi, int(oi), rots[k], t))
            which.append(int(oi))
    ren = render(meshes, inst, cam_k, n_pool, h, w)
    # an object's pixels carry its model coordinates c, normalized per axis
    # by its norm factors, as the colours that a generator returning
    # tanh(gain * x) decodes to code_scale * c: x = atanh(code_scale * c) /
    # gain, colour 128 + 128 x; the background is near-gray noise of
    # +- background_levels
    norms = [norm_factor(m["verts"]) for m in meshes]
    nf = torch.stack([norms[oi] for oi in which])
    a, gain = mix["code_scale"], cfg["passthrough_gain"]
    back = smooth_noise(gen, n_pool, h, w, 24, device)
    rgb = torch.empty((n_pool, h, w, 3), dtype=torch.uint8, device=device)
    for fi in range(n_pool):
        k = ren["inst"][fi]
        f = nf[k.clamp(min=0)]
        code = ((ren["xyz"][fi] - f[..., 3:]) / f[..., :3]).clamp(-1.0, 1.0)
        x = torch.atanh(a * code) / gain
        noise = (back[fi] * 2.0 - 1.0) * mix["background_levels"] / 128.0
        val = 128.0 + 128.0 * torch.where((k >= 0)[..., None], x, noise)
        rgb[fi] = val.round().clamp(0, 255).to(torch.uint8)

    inst_map = ren["inst"].cpu().numpy()
    jit = mix["box_jitter_px"]
    dets = [[] for _ in range(n_pool)]
    truth = [[] for _ in range(n_pool)]
    for k, (fi, oi, rot, t) in enumerate(inst):
        m = inst_map[fi] == k
        if m.sum() < mix["min_visible_px"]:
            continue
        vv, uu = np.nonzero(m)
        j = rng.integers(-jit, jit + 1, 4)
        box = np.array([max(vv.min() + j[0], 0), max(uu.min() + j[1], 0),
                        min(vv.max() + j[2], h - 1),
                        min(uu.max() + j[3], w - 1)], np.int32)
        dets[fi].append((objs[oi]["id"], box,
                         float(rng.uniform(0.85, 1.0)), m))
        truth[fi].append((rot.cpu().numpy(), t.cpu().numpy()))
    return {"rgb": rgb.cpu().numpy(), "dets": dets, "truth": truth,
            "meshes": meshes, "cam_k": cam_k, "norm": norms}


def camera_matrix(cfg: dict, device) -> torch.Tensor:
    c = cfg["camera"]
    return torch.tensor([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def stamp(rgb: np.ndarray, req_id: int, pool: int) -> np.ndarray:
    """A frame as one request sends it: the request id (u32) and the pool
    index (u16) written into the first two pixels of row 0."""
    out = rgb.copy()
    out.reshape(-1)[:6] = np.frombuffer(
        np.array([req_id], "<u4").tobytes()
        + np.array([pool], "<u2").tobytes(), np.uint8)
    return out


def read_stamp(rgb: np.ndarray) -> tuple[int, int]:
    raw = np.ascontiguousarray(rgb.reshape(-1)[:6]).tobytes()
    return (int(np.frombuffer(raw[:4], "<u4")[0]),
            int(np.frombuffer(raw[4:], "<u2")[0]))


# -------------------------------------------------------- training patches
def build_patches(cfg: dict, mix: dict, seed: int, device) -> dict:
    """Training patches of one object, as the reference's pair renderer
    stores them: ``rgb`` and ``xyz`` (N, 128, 128, 3) uint8 (coordinate
    colours through the object's norm factors), ``mask`` (N, 128, 128)
    bool, ``extent`` (N,) float32, each patch centred; ``backs`` (M, 256,
    256, 3) uint8. Also the mesh and its norm factors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    obj = next(o for o in cfg["objects"] if o["id"] == mix["object"])
    mesh = make_mesh(gen, obj["diameter_mm"], cfg["mesh_level"], device)
    norm = norm_factor(mesh["verts"])
    n, side = mix["patches"], 256
    cam_k = torch.tensor([[572.4114, 0.0, 128.0], [0.0, 573.57043, 128.0],
                          [0.0, 0.0, 1.0]], device=device)
    z = obj["diameter_mm"] * 572.0 / mix["patch_px"]
    rots = random_rotations(gen, n, device)
    t = torch.tensor([0.0, 0.0, z], device=device)
    rgb = torch.zeros((n, 128, 128, 3), dtype=torch.uint8, device=device)
    xyz = torch.zeros_like(rgb)
    mask = torch.zeros((n, 128, 128), dtype=torch.bool, device=device)
    extent = torch.zeros(n, device=device)
    chunk = 16
    shade = 0.6 + 0.4 * torch.rand(n, generator=gen, device=device)
    for c0 in range(0, n, chunk):
        ids = range(c0, min(n, c0 + chunk))
        ren = render([mesh], [(i - c0, 0, rots[i], t) for i in ids], cam_k,
                     len(ids), side, side)
        for k, i in enumerate(ids):
            m = ren["inst"][k] >= 0
            vv, uu = torch.nonzero(m, as_tuple=True)
            v0, v1 = int(vv.min()), int(vv.max()) + 1
            u0, u1 = int(uu.min()), int(uu.max()) + 1
            hh, ww = min(v1 - v0, 128), min(u1 - u0, 128)
            pv, pu = (128 - hh) // 2, (128 - ww) // 2
            col = (ren["color"][k] * shade[i] * 255).round().clamp(0, 255)
            c01 = ((ren["xyz"][k] - norm[3:]) / norm[:3] + 1.0) * 0.5
            code = (c01 * 255).clamp(0, 255).to(torch.uint8)
            sl = (slice(v0, v0 + hh), slice(u0, u0 + ww))
            dst = (i, slice(pv, pv + hh), slice(pu, pu + ww))
            rgb[dst] = torch.where(m[sl][..., None], col[sl], 0) \
                .to(torch.uint8)
            xyz[dst] = torch.where(m[sl][..., None], code[sl], 0)
            mask[dst] = m[sl] & (xyz[dst].sum(-1) > 0)
            extent[i] = float(max(hh, ww))
    backs = (smooth_noise(gen, mix["backgrounds"], 256, 256, 16, device)
             * 255).round().to(torch.uint8)
    return {"rgb": rgb, "xyz": xyz, "mask": mask, "extent": extent,
            "backs": backs, "mesh": mesh, "norm": norm}
