"""Normalized-coordinate ("XYZ") colour codec (port of
:mod:`pix2pose_tpu.ops.color`).

Each object's model coordinates are affinely mapped to RGB, so an unlit
render of the recoloured model is a per-pixel coordinate map (reference
``tools/2_1_ply_file_to_3d_coord_model.py:30-63``); inference inverts the
map (reference ``pix2pose_model/recognition.py:197-202``).
"""

from __future__ import annotations

import numpy as np
import torch


def norm_factor_from_vertices(vertices, center: bool = True):
    """Per-axis (scale, center) for coordinate colorization:
    ``scale[k] = max |v[:, k] - mean(v[:, k])|``, ``center[k] =
    mean(v[:, k])``, centers forced to zero when ``center`` is False
    (reference ``tools/2_1_ply_file_to_3d_coord_model.py:34-47``).
    (N, 3) vertices -> ((3,), (3,)) float32 tensors on their device."""
    vertices = torch.as_tensor(vertices, dtype=torch.float32)
    ct = vertices.mean(dim=0)
    if not center:
        ct = torch.zeros_like(ct)
    scale = torch.abs(vertices - ct).amax(dim=0)
    return scale, ct


def xyz_to_color01(xyz, scale, ct):
    """Model coordinates -> colour in [0, 1]: ``c = ((x - ct)/scale + 1)/2``
    (reference ``2_1:50-58``), not clipped (the reference leaves the
    overshoot of asymmetric-center axes)."""
    return ((torch.as_tensor(xyz) - ct) / scale + 1.0) * 0.5


def color01_to_xyz(color01, scale, ct):
    """Colour in [0, 1] -> model coordinates: ``x = (c*2 - 1)*scale + ct``
    (reference ``recognition.py:198-202``). Broadcasts over leading axes."""
    return (torch.as_tensor(color01) * 2.0 - 1.0) * scale + ct


def tanh_to_color01(decoded):
    """Network tanh output in [-1, 1] -> clipped colour in [0, 1]
    (reference ``recognition.py:85-88``)."""
    return torch.clamp((torch.as_tensor(decoded) + 1.0) * 0.5, 0.0, 1.0)


def colorize_vertices_u8(vertices, scale=None, ct=None) -> np.ndarray:
    """uint8 vertex colours of a ``models_xyz`` PLY: the float32 colour
    times 255, truncated (reference ``2_1:59-61``, a float -> uint8 cast).
    Norm factors default to :func:`norm_factor_from_vertices`."""
    vertices = torch.as_tensor(np.asarray(vertices, np.float32))
    if scale is None or ct is None:
        s, c = norm_factor_from_vertices(vertices)
        scale = s if scale is None else scale
        ct = c if ct is None else ct
    col = xyz_to_color01(vertices, torch.as_tensor(np.asarray(scale)),
                         torch.as_tensor(np.asarray(ct)))
    return (col.numpy() * 255).astype(np.uint8)


def obj_param_from_norm_factor(model_param: dict) -> np.ndarray:
    """Flatten a ``norm_factor.json`` entry into the 6-vector
    [x_scale, y_scale, z_scale, x_ct, y_ct, z_ct] the estimator takes
    (reference ``tools/bop_io.py:33-42``)."""
    return np.array([model_param["x_scale"], model_param["y_scale"],
                     model_param["z_scale"], model_param["x_ct"],
                     model_param["y_ct"], model_param["z_ct"]],
                    dtype=np.float32)
