"""Minimal standalone PLY mesh I/O (ascii + binary little/big endian).

The reference reads models through ``plyfile`` / ``bop_toolkit_lib.inout``
and vispy GL buffers (``rendering/model.py:74-140``); this framework needs
only numpy arrays for the rasterizer, so we parse PLY directly. A copy of
:mod:`pix2pose_tpu.data.ply`.

Supported: vertex properties x/y/z, nx/ny/nz, red/green/blue (+alpha),
texture_u/v; triangular (and quad, triangulated) faces.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path):
    """Load a PLY mesh.

    Returns dict with ``pts`` (V,3) f32, ``faces`` (F,3) i32 and, when
    present, ``normals`` (V,3), ``colors`` (V,3) u8, ``texture_uv`` (V,2).
    """
    with open(path, "rb") as f:
        line = f.readline().decode("ascii").strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)| list-prop])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = {"name": name, "count": int(cnt), "props": []}
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur["props"].append(("list", parts[2], parts[3],
                                         parts[4]))
                else:
                    cur["props"].append(("scalar", parts[1], parts[2]))
            elif line == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">",
                  "ascii": None}[fmt]
        out = {}
        for el in elements:
            if fmt == "ascii":
                rows = [f.readline().decode("ascii").split()
                        for _ in range(el["count"])]
                out[el["name"]] = _parse_ascii(el, rows)
            else:
                out[el["name"]] = _parse_binary(el, f, endian)

    result = {}
    if "vertex" in out:
        v = out["vertex"]
        result["pts"] = np.stack(
            [v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
        if "nx" in v:
            result["normals"] = np.stack(
                [v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
        if "red" in v:
            result["colors"] = np.stack(
                [v["red"], v["green"], v["blue"]], axis=1).astype(np.uint8)
        if "texture_u" in v:
            result["texture_uv"] = np.stack(
                [v["texture_u"], v["texture_v"]], axis=1).astype(np.float32)
    if "face" in out:
        face = out["face"]
        if isinstance(face, dict):  # face-wise texcoord variant
            result["faces"] = face["faces"]
            # scatter per-face-corner UVs onto vertices, last write wins —
            # the reference's exact (lossy) collation, ``model.py:106-113``
            tc = face["texcoord"].reshape(-1, 2)
            uv = np.zeros((result["pts"].shape[0], 2), np.float32)
            uv[face["faces"].reshape(-1)] = tc
            result.setdefault("texture_uv", uv)
        else:
            result["faces"] = face
    return result


def _parse_ascii(el, rows):
    has_list = any(p[0] == "list" for p in el["props"])
    if has_list:
        faces, texcoords = [], []
        for r in rows:
            pos = 0
            fields = {}
            for p in el["props"]:
                if p[0] == "list":
                    n = int(r[pos])
                    fields[p[3]] = r[pos + 1:pos + 1 + n]
                    pos += 1 + n
                else:
                    fields[p[2]] = r[pos]
                    pos += 1
            idx = [int(x) for x in fields.get("vertex_indices",
                                              fields.get("vertex_index",
                                                         []))]
            tc = [float(x) for x in fields.get("texcoord", [])]
            n = len(idx)
            if n == 3:
                faces.append(idx)
                if tc:
                    texcoords.append(tc)
            elif n == 4:  # triangulate quads
                faces.append(idx[:3])
                faces.append([idx[0], idx[2], idx[3]])
                if tc:
                    texcoords.append(tc[:6])
                    texcoords.append([tc[0], tc[1], tc[4], tc[5],
                                      tc[6], tc[7]])
        faces = np.asarray(faces, np.int32)
        if texcoords:
            return {"faces": faces,
                    "texcoord": np.asarray(texcoords, np.float32)}
        return faces
    cols = {}
    arr = np.asarray(rows, np.float64)
    for i, (_, _, name) in enumerate(el["props"]):
        cols[name] = arr[:, i]
    return cols


def _parse_binary(el, f, endian):
    has_list = any(p[0] == "list" for p in el["props"])
    if not has_list:
        dt = np.dtype([(p[2], endian + _DTYPES[p[1]])
                       for p in el["props"]])
        data = np.frombuffer(f.read(dt.itemsize * el["count"]), dt)
        return {name: data[name] for name in data.dtype.names}
    # list properties (faces, optionally face-wise texcoord as in the
    # reference's textured models, ``rendering/model.py:106-109``); fixed
    # arity probed from the first record
    props = el["props"]
    if len(props) == 2 and all(p[0] == "list" for p in props) \
            and {p[3] for p in props} >= {"texcoord"}:
        return _parse_binary_face_texcoord(el, f, endian)
    if len(props) != 1:
        raise ValueError("unsupported face element with extra properties")
    _, cnt_t, idx_t, _ = props[0]
    cnt_dt = np.dtype(endian + _DTYPES[cnt_t])
    idx_dt = np.dtype(endian + _DTYPES[idx_t])
    start = f.tell()
    first_n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
    f.seek(start)
    rec = np.dtype([("n", cnt_dt), ("idx", idx_dt, (first_n,))])
    raw = f.read(rec.itemsize * el["count"])
    data = np.frombuffer(raw, rec, count=el["count"])
    if not (data["n"] == first_n).all():
        # mixed arity: slow path
        f.seek(start)
        faces = []
        for _ in range(el["count"]):
            n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
            idx = np.frombuffer(f.read(idx_dt.itemsize * n), idx_dt,
                                count=n).astype(np.int64)
            if n == 3:
                faces.append(idx)
            elif n == 4:
                faces.append(idx[:3])
                faces.append(idx[[0, 2, 3]])
        return np.asarray(faces, np.int32)
    idx = data["idx"].astype(np.int64)
    if first_n == 3:
        return idx.astype(np.int32)
    if first_n == 4:
        tris = np.concatenate([idx[:, :3], idx[:, [0, 2, 3]]], axis=0)
        return tris.astype(np.int32)
    raise ValueError(f"unsupported face arity {first_n}")


def _parse_binary_face_texcoord(el, f, endian):
    """Face element with two list props (vertex_indices + texcoord).

    Assumes fixed arity probed from the first record (triangles with 6
    texcoord floats is the layout the reference's textured models use);
    falls back to a per-record loop when arities vary.
    """
    props = {p[3]: p for p in el["props"]}
    order = [p[3] for p in el["props"]]
    dts = {name: (np.dtype(endian + _DTYPES[p[1]]),
                  np.dtype(endian + _DTYPES[p[2]]))
           for name, p in props.items()}
    start = f.tell()
    # probe first record's arities in property order
    arity = {}
    for name in order:
        cnt_dt, item_dt = dts[name]
        n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
        f.seek(item_dt.itemsize * n, 1)
        arity[name] = n
    f.seek(start)
    fields = []
    for name in order:
        cnt_dt, item_dt = dts[name]
        fields += [(f"n_{name}", cnt_dt),
                   (name, item_dt, (arity[name],))]
    rec = np.dtype(fields)
    raw = f.read(rec.itemsize * el["count"])
    data = np.frombuffer(raw, rec, count=el["count"])
    fixed = all((data[f"n_{name}"] == arity[name]).all() for name in order)
    if not fixed:
        f.seek(start)
        rows = []
        for _ in range(el["count"]):
            row = {}
            for name in order:
                cnt_dt, item_dt = dts[name]
                n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                row[name] = np.frombuffer(
                    f.read(item_dt.itemsize * n), item_dt, count=n)
            rows.append(row)
        idx_name = ("vertex_indices" if "vertex_indices" in props
                    else "vertex_index")
        return {"faces": np.asarray([r[idx_name] for r in rows], np.int32),
                "texcoord": np.asarray([r["texcoord"] for r in rows],
                                       np.float32)}
    idx_name = ("vertex_indices" if "vertex_indices" in props
                else "vertex_index")
    return {"faces": data[idx_name].astype(np.int32),
            "texcoord": data["texcoord"].astype(np.float32)}


def find_texture(ply_path):
    """Sibling texture image for a mesh, reference discovery rule
    (``rendering/model.py:94-99``): ``<stem>.jpg`` then ``<stem>.png``
    next to the PLY. Returns the path or None."""
    import os

    stem = os.path.splitext(ply_path)[0]
    for ext in (".jpg", ".png"):
        if os.path.exists(stem + ext):
            return stem + ext
    return None


def load_texture(path):
    """Decode a texture image to (Ht, Wt, 3) float32 in [0, 255],
    image-row order (row 0 = top). The GL vertical flip the reference
    applies at load (``model.py:103``) is instead folded into
    :func:`pix2pose_torch.ops.texture.sample_texture`'s coordinates."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return img.astype(np.float32)


def save_ply(path, pts, faces=None, colors=None, normals=None):
    """Write a binary little-endian PLY (vertex colors optional) — used by
    the model colorizer to emit ``models_xyz/*.ply``
    (reference ``2_1_ply_file_to_3d_coord_model.py:62``)."""
    pts = np.asarray(pts, np.float32)
    n = pts.shape[0]
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    rec = np.zeros(n, np.dtype([(k, "<" + t) for k, t in props]))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = (normals[:, 0], normals[:, 1],
                                           normals[:, 2])
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        rec["red"], rec["green"], rec["blue"] = (colors[:, 0], colors[:, 1],
                                                 colors[:, 2])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            frec = np.zeros(faces.shape[0],
                            np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
            frec["n"] = 3
            frec["idx"] = faces
            f.write(frec.tobytes())
