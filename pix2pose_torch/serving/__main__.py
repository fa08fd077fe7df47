"""``python -m pix2pose_torch serve`` -- the TCP pose-serving CLI (port of
:mod:`pix2pose_tpu.serving.__main__`).

Reference equivalent: ``ros_kinetic/ros_pix2pose.py <gpu> <cfg>`` (a ROS
node). The same stack serves over the in-repo TCP protocol
(``serving/server.py``): cross-client request coalescing into one
images x objects batch, optional batched depth / ICP refinement, whose
depth renders run the CUDA z-buffer kernel.

    python -m pix2pose_torch serve ros_config.json <dataset_dir> <dataset> \\
        [--port 7707] [--icp] [--max-det 4] [--max-batch 8] [--device cuda]

Weights and norm factors load with the evaluator's conventions:
``<dataset>/pix2pose_weights/<obj:02d>/inference.npz`` (one generator
per object, backbone from the config), ``models_xyz/norm_factor.json``
(``colorize-models`` writes it), and the in-repo CenterNet detector from
``weight_detection/centernet/inference.npz``. Every checkpoint is loaded
strictly at start-up. The server runs on ``--device`` (default ``cuda``);
without a CUDA device it refuses to start unless ``--device cpu`` is
given.
"""

from __future__ import annotations

from typing import Sequence


def create_server(argv: Sequence[str] | None = None):
    """Parse args, load weights and meshes, return a live
    :class:`~pix2pose_torch.serving.server.PoseServer` (the caller owns
    ``close``). :func:`main` wraps this and blocks."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch serve")
    p.add_argument("ros_cfg", help="ros_config.json (reference schema)")
    p.add_argument("dataset_dir", help="BOP datasets root")
    p.add_argument("dataset", help="dataset name (weights + models live "
                                   "under it)")
    p.add_argument("--port", type=int, default=7707)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--icp", action="store_true",
                   help="enable the batched depth/ICP refinement path "
                        "(requires depth in requests)")
    p.add_argument("--max-det", type=int, default=4)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--norm-factor", default="norm_factor.json")
    p.add_argument("--device", default="cuda",
                   help="torch device of the models and kernels")
    args = p.parse_args(argv)

    from pix2pose_torch.utils.cli import (load_generators, load_norm_params,
                                          load_torch_detector,
                                          require_device)

    device = require_device(args.device)

    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.data.ply import load_ply
    from pix2pose_torch.models import build_generator
    from pix2pose_torch.serving.server import PoseServer
    from pix2pose_torch.serving.service import PoseService, ServingConfig
    from pix2pose_torch.serving.viz import bbox_corners

    cfg = ServingConfig.load(args.ros_cfg)
    if args.icp:
        cfg.icp = True
    ds = BopDataset(args.dataset_dir, args.dataset, train=False)

    model = build_generator(cfg.backbone)
    # cfg.obj_labels (reference ros_config "obj_labels") filters which
    # objects serve; empty = every object with trained weights
    wanted = set(cfg.obj_labels) if cfg.obj_labels else None
    params_by_obj = load_generators(
        ds, model, [o for o in ds.model_ids if wanted is None or o in wanted],
        device)
    obj_params = load_norm_params(ds, params_by_obj, args.norm_factor)
    corners, meshes_m = {}, {}
    for obj_id in params_by_obj:
        mesh = load_ply(ds.model_ply_path(obj_id))
        corners[obj_id] = bbox_corners(mesh["pts"])
        if cfg.icp:
            meshes_m[obj_id] = (mesh["pts"] * cfg.model_scale,
                                mesh["faces"])
    if not params_by_obj:
        raise SystemExit("no trained objects found — train first "
                         "(python -m pix2pose_tpu train ..., then convert "
                         "the checkpoint: pix2pose_torch.utils.checkpoint)")

    detector = load_torch_detector(ds, device)

    svc = PoseService(cfg, detector, model, params_by_obj, obj_params,
                      corners, max_det=args.max_det,
                      meshes_m=meshes_m or None, device=device)
    server = PoseServer(svc, host=args.host, port=args.port,
                        max_batch=args.max_batch)
    host, port = server.address
    print(f"serving {sorted(params_by_obj)} on {host}:{port} "
          f"(icp={cfg.icp}, device={device})")
    return server


def main(argv: Sequence[str] | None = None):
    server = create_server(argv)
    try:
        import threading

        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.close()


if __name__ == "__main__":
    main()
