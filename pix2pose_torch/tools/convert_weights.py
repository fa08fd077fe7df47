"""Weight converter (port of :mod:`pix2pose_tpu.tools.convert_weights`;
reference ``tools/4_convert_weights_inference.py``).

Writes a generator's deployment artifact, ``<weight_dir>/inference.npz``:

- from the newest ``epoch_XXXX.pt`` train state of the port's trainer
  (the reference's filename scan, ``4_convert:21-38``), or else
- from a reference Keras ``inference.hdf5`` (paper backbone) /
  ``inference_resnet_model.hdf5`` / ``inference_resnet50.hdf5``
  (ResNet-50), the loader chosen by the file's name.

The JAX tool reads ``inference_resnet_model.hdf5`` with the paper loader
(a ``KeyError`` on ``conv1_1``) and never looks for
``inference_resnet50.hdf5``; here both go to the ResNet-50 loader.

CLI (``--device`` defaults to ``cuda``; without a CUDA device the command
refuses to start unless ``--device cpu`` is given)::

    python -m pix2pose_torch convert-weights <weight_dir> \\
        [--backbone paper] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence


def convert(weight_dir: str, backbone: str = "paper", device="cuda") -> str:
    """Export ``weight_dir``'s generator to ``inference.npz``; returns the
    path. ``backbone`` names the train state's generator (a Keras file's
    backbone follows from its name)."""
    import torch

    from pix2pose_torch.config import TrainConfig
    from pix2pose_torch.models import AutoEncoder, Discriminator
    from pix2pose_torch.training.gan import create_train_state
    from pix2pose_torch.utils import checkpoint as ckpt
    from pix2pose_torch.utils.convert import state_dict_to_flax

    dev = torch.device(device)
    if ckpt.latest_epoch(weight_dir) >= 0:
        cfg = TrainConfig(backbone=backbone)
        template = create_train_state(
            AutoEncoder(backbone=backbone).to(dev),
            Discriminator(cfg.im_size).to(dev), cfg)
        state, epoch = ckpt.restore_train_state(weight_dir, template)
        path = ckpt.export_inference(
            weight_dir, state_dict_to_flax(state.gen.state_dict()))
        print(f"exported inference params from epoch {epoch} -> {path}")
        return path
    for name in ckpt.KERAS_NAMES:
        h5 = os.path.join(weight_dir, name)
        if os.path.exists(h5):
            from pix2pose_torch.utils.hdf5_import import load_keras_inference

            gen = AutoEncoder(backbone="resnet50" if "resnet" in name
                              else "paper")
            path = ckpt.export_inference(weight_dir,
                                         load_keras_inference(h5, gen))
            print(f"converted {h5} -> {path}")
            return path
    raise SystemExit(f"no training checkpoints or hdf5 in {weight_dir}")


def main(argv: Sequence[str] | None = None):
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch "
                                     "convert-weights",
                                description=__doc__.split("\n")[0])
    p.add_argument("weight_dir")
    p.add_argument("--backbone", default="paper")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return convert(args.weight_dir, args.backbone,
                   require_device(args.device))


if __name__ == "__main__":
    main()
