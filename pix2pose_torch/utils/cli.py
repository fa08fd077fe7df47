"""Start-up helpers shared by the command-line entry points (``serve``,
``eval``, ``eval-icp``, ``run-detector``, ``train``): the device check
with the float32 precision pin, and the checkpoint loading, with the JAX
package's directory conventions."""

from __future__ import annotations

import os

import numpy as np


def require_device(name: str):
    """``torch.device(name)``; exits when it names CUDA and none is
    present (the caller passes ``--device cpu`` to run on the CPU).

    Pins convolutions and matmuls to full float32: cuDNN and cuBLAS may
    otherwise round their inputs to TF32 on the GPU (cuDNN does by
    default), and every parity bar of the port, like the JAX package,
    assumes float32."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    return device


def load_generators(ds, model, obj_ids, device) -> dict:
    """{obj_id: generator state dict on ``device``} for each of
    ``obj_ids`` with ``<dataset>/pix2pose_weights/<obj:02d>/
    inference.npz``; each is loaded strictly into ``model`` once as a
    check. Objects without weights are skipped with a message."""
    from pix2pose_torch.utils import checkpoint as ckpt_util
    from pix2pose_torch.utils.convert import flax_to_state_dict

    out = {}
    for obj_id in obj_ids:
        wdir = os.path.join(ds.dir, "pix2pose_weights", f"{obj_id:02d}")
        variables = ckpt_util.load_inference_params(wdir)
        if variables is None:
            print(f"skip obj {obj_id}: no weights under {wdir}")
            continue
        state = flax_to_state_dict(variables)
        model.load_state_dict(state, strict=True)
        out[obj_id] = {k: v.to(device) for k, v in state.items()}
    return out


def load_norm_params(ds, obj_ids, norm_factor_fn="norm_factor.json"
                     ) -> dict:
    """{obj_id: (6,) [scale_xyz, ct_xyz]} from ``models_xyz/<fn>``."""
    import json

    from pix2pose_torch.ops.color import obj_param_from_norm_factor

    with open(os.path.join(ds.dir, "models_xyz", norm_factor_fn)) as f:
        norm = json.load(f)
    return {o: np.asarray(obj_param_from_norm_factor(norm[str(o)]),
                          np.float32) for o in obj_ids}


def load_torch_detector(ds, device, score_th: float = 0.3):
    """The CenterNet detector of ``weight_detection/centernet`` as a
    :class:`~pix2pose_torch.inference.torch_detector.TorchDetector`."""
    from pix2pose_torch.inference.torch_detector import TorchDetector
    from pix2pose_torch.models import CenterNetDetector
    from pix2pose_torch.utils import checkpoint as ckpt_util
    from pix2pose_torch.utils.convert import flax_to_state_dict

    det_vars = ckpt_util.load_inference_params(
        os.path.join(ds.dir, "weight_detection", "centernet"))
    if det_vars is None:
        raise SystemExit("no trained detector under weight_detection/"
                         "centernet — run detector training first")
    return TorchDetector(CenterNetDetector(num_classes=len(ds.model_ids)),
                         flax_to_state_dict(det_vars), ds.model_ids,
                         score_th=score_th, device=device)
