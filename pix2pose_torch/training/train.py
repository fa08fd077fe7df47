"""Per-object GAN training of the generator (port of
:mod:`pix2pose_tpu.training.train`).

CLI mirror of ``python3 tools/3_train_pix2pose.py <gpu> <cfg> <dataset>
<obj_id> <background_dir>``; ``--device`` (default ``cuda``) replaces the
gpu argument, and without a CUDA device the command refuses to start
unless ``--device cpu`` is given::

    python -m pix2pose_torch train <cfg.json> <dataset> <obj_id> \\
        <background_dir> [--epochs N] [--batch B] [--max-steps S] \\
        [--imagenet-h5 F] [--dtype float32|bfloat16] [--device cuda]

Reference semantics kept: the symmetry pool from models_info filtered by
the pair renderer's probe (``3_train:96-111``), epoch = min(n_data /
batch * 10, 3000) batches (``3_train:191``), the BOP lr schedule
(``3_train:169-173``), a checkpoint per epoch with resume from the newest
(``3_train:139-167,247-250``), a validation montage per epoch
(``3_train:252-264``), and the generator-only inference export at the end
(``3_train:271-277``), here ``inference.npz``, which the port's
``eval`` / ``serve`` read.

One difference from the JAX trainer, on purpose: with a custom
``data_dir`` the symmetry pool's ``meta.json`` is read from that
directory's parent, the data being trained on (the JAX trainer reads the
dataset's ``train_xyz`` whatever ``data_dir`` is).
"""

from __future__ import annotations

from typing import Sequence

from pix2pose_torch.config import TrainConfig
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.training.multi import train_objects


def train_object(dataset: BopDataset, obj_id: int, back_dir: str,
                 cfg: TrainConfig = TrainConfig(),
                 weight_root: str | None = None,
                 data_dir: str | None = None,
                 log_every: int = 10, max_steps: int | None = None,
                 imagenet_h5: str | None = None, device="cuda"):
    """Train one object's generator on ``device`` from the pairs in
    ``data_dir`` (default ``<dataset>/train_xyz/<obj:02d>``); returns the
    final :class:`~pix2pose_torch.training.gan.GanTrainState`. This is
    :func:`~pix2pose_torch.training.multi.train_objects` with one object.

    ``imagenet_h5``: the keras-applications notop ResNet-50 ImageNet file;
    with the resnet50 backbone a FRESH run initializes the encoder trunk
    from it (the reference's pretrained init, ``resnet50_mod.py:246-258``).
    Ignored when resuming from a checkpoint.
    """
    runs = train_objects(dataset, [obj_id], back_dir, cfg,
                         weight_root=weight_root, log_every=log_every,
                         max_steps=max_steps, imagenet_h5=imagenet_h5,
                         device=device,
                         data_dirs=None if data_dir is None else [data_dir])
    return runs[0].state


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch train")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("obj_id", type=int)
    p.add_argument("back_dir")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--imagenet-h5", default=None,
                   help="keras-applications notop resnet50 h5: pretrained "
                        "trunk init for fresh resnet50-backbone runs "
                        "(reference resnet50_mod.py:246-258)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="conv compute dtype (mixed precision; params fp32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    args = p.parse_args(argv)
    device = require_device(args.device)

    ecfg = load_eval_config(args.cfg)
    ds = BopDataset(ecfg.dataset_dir, args.dataset, train=True)
    kw = {"backbone": ecfg.backbone, "compute_dtype": args.dtype}
    if args.epochs:
        kw.update(max_epoch=args.epochs, batch_size=args.batch or 50)
    elif args.batch:
        kw.update(batch_size=args.batch)
    tcfg = TrainConfig(**kw)
    return train_object(ds, args.obj_id, args.back_dir, tcfg,
                        max_steps=args.max_steps,
                        imagenet_h5=args.imagenet_h5, device=device)


if __name__ == "__main__":
    main()
