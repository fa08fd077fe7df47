"""XYZ model colorizer (port of :mod:`pix2pose_tpu.tools.colorize_models`,
reference ``tools/2_1_ply_file_to_3d_coord_model.py``).

For every model of a dataset: per-axis norm factors (max abs deviation
from the vertex mean, and the mean), a vertex-coloured
``models_xyz/obj_XXXXXX.ply`` and the aggregate ``norm_factor.json``,
which the serving CLI and the evaluators read.

    python -m pix2pose_torch colorize-models <cfg.json> <dataset>
"""

from __future__ import annotations

import json
import os
from typing import Sequence

from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.data.ply import load_ply, save_ply
from pix2pose_torch.ops import color as color_ops


def colorize_dataset(ds: BopDataset, center: bool = True) -> dict:
    """Process all models; returns the norm-factor dict and writes
    ``models_xyz/``."""
    xyz_dir = os.path.join(ds.dir, "models_xyz")
    os.makedirs(xyz_dir, exist_ok=True)
    params = {}
    for obj_id in ds.model_ids:
        mesh = load_ply(ds.model_ply_path(obj_id))
        scale, ct = (x.numpy() for x in color_ops.norm_factor_from_vertices(
            mesh["pts"], center=center))
        colors = color_ops.colorize_vertices_u8(mesh["pts"], scale, ct)
        save_ply(os.path.join(xyz_dir, f"obj_{obj_id:06d}.ply"),
                 mesh["pts"], mesh.get("faces"), colors)
        params[int(obj_id)] = {
            "x_scale": float(scale[0]), "y_scale": float(scale[1]),
            "z_scale": float(scale[2]), "x_ct": float(ct[0]),
            "y_ct": float(ct[1]), "z_ct": float(ct[2])}
        print(obj_id, *params[int(obj_id)].values())
    with open(os.path.join(xyz_dir, "norm_factor.json"), "w") as f:
        json.dump(params, f)
    return params


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config

    p = argparse.ArgumentParser()
    p.add_argument("cfg")
    p.add_argument("dataset")
    args = p.parse_args(argv)
    cfg = load_eval_config(args.cfg)
    colorize_dataset(BopDataset(cfg.dataset_dir, args.dataset, train=True))


if __name__ == "__main__":
    main()
