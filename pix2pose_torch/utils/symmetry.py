"""Continuous-symmetry pose canonicalization.

Reference ``get_sympose`` (``tools/2_2_render_pix2pose_training.py:26-52``):
for an object with a continuous symmetry axis, zero the euler angle around
that axis (extrinsic decomposition with the symmetry axes first) so all
training poses share one canonical azimuth; if the transformed symmetry
axis is near-parallel to the camera z-axis, lock in-plane rotation
augmentation.

A copy of :mod:`pix2pose_tpu.utils.symmetry`: the two canonicalizations
and the trainer's symmetry pool.
"""

from __future__ import annotations

import numpy as np


def canonicalize_sym_pose(rot: np.ndarray, sym_axis) -> tuple[np.ndarray,
                                                              bool]:
    """Args:
      rot: (3, 3) cam_R_m2c.
      sym_axis: length-3 0/1 vector marking continuous-symmetry axes
        (models_info ``symmetries_continuous[0]['axis']``), or None.

    Returns:
      (canonicalized rotation, rotation_lock).
    """
    sym_axis = np.asarray(sym_axis if sym_axis is not None else [0, 0, 0],
                          np.float64)
    if sym_axis.sum() <= 0:
        return rot, False
    from scipy.spatial.transform import Rotation

    axes = "xyz"
    order = "".join(a for i, a in enumerate(axes) if sym_axis[i] == 1) + \
        "".join(a for i, a in enumerate(axes) if sym_axis[i] == 0)
    keep = [0.0 if sym_axis["xyz".index(c)] == 1 else 1.0 for c in order]
    # extrinsic (static-frame) euler == lowercase order in scipy, matching
    # transforms3d's 's' prefix used by the reference
    ang = Rotation.from_matrix(rot).as_euler(order)
    ang = ang * np.asarray(keep)
    rot_c = Rotation.from_euler(order, ang).as_matrix()
    sym_tr = rot_c @ sym_axis
    lock = bool(abs(float(sym_tr @ np.array([0.0, 0.0, 1.0]))) > 0.8)
    return rot_c.astype(rot.dtype if hasattr(rot, "dtype")
                        else np.float32), lock


def canonicalize_discrete(rot: np.ndarray, pool: np.ndarray):
    """Pick the discrete-symmetry representative with a view-consistent
    deterministic frame: ``argmax_T f(R @ T)`` over the pool, with
    ``f(M) = <M @ e_ref, c>`` for fixed generic vectors. DESIGN DELTA
    (beyond the reference): the reference leaves discrete symmetry
    entirely to the per-sample argmin in the transformer loss
    (``ae_model.py:39-57``), which lets the generator converge to a
    DIFFERENT symmetry frame per viewpoint when the appearance alone
    disambiguates — measured on the multishape prism(z180): frame share
    flipped 0.04-0.91 across test views, decoded-XYZ error 23-53 mm,
    e2e AR 0.0 at both 6k and 12k steps. Canonicalizing the TARGET
    frame at pair-render time gives every view a consistent target; the
    loss argmin is kept for the genuine-ambiguity boundary (views where
    f changes sign under some pool member are exactly the views whose
    two frames look most alike).

    Args:
      rot: (3, 3) cam_R_m2c.
      pool: (S, 3, 3) discrete rotation pool, identity first
        (``BopDataset.symmetry_pool``).

    Returns:
      (3, 3) ``rot @ pool[k*]``, deterministic across views.
    """
    pool = np.asarray(pool, np.float64)
    if pool.shape[0] <= 1:
        return rot
    # generic reference functional: break ties on a second axis so
    # 4-fold pools (two members fixing e_x) stay deterministic
    c = np.array([1.0, 0.37, 0.089])
    c2 = np.array([-0.21, 0.93, 0.41])
    best, best_key = None, None
    for T in pool:
        m = np.asarray(rot, np.float64) @ T
        key = (round(float(m[:, 0] @ c), 9), round(float(m[:, 1] @ c2), 9))
        if best is None or key > best_key:
            best, best_key = m, key
    return best.astype(rot.dtype if hasattr(rot, "dtype")
                       else np.float32)


def training_sym_pool(ds, obj_id: int, out_root=None) -> np.ndarray:
    """The symmetry pool the TRAINER should argmin over: the geometric
    pool (``BopDataset.symmetry_pool``) filtered to the members the pair
    renderer's appearance probe marked as VISUAL symmetries
    (``<out_root>/<obj:02d>/meta.json: visual_sym_idx``; ``out_root``
    defaults to ``<dataset>/train_xyz``). Falls back to the full
    geometric pool when no probe record exists (pairs rendered by an
    older version, or externally supplied data), i.e. exact reference
    behavior. Evaluation always keeps the full geometric pool.
    """
    import json
    import os

    pool = ds.symmetry_pool(obj_id)
    meta_p = os.path.join(out_root or os.path.join(ds.dir, "train_xyz"),
                          f"{obj_id:02d}", "meta.json")
    try:
        with open(meta_p) as f:
            idx = json.load(f).get("visual_sym_idx")
    except (OSError, ValueError):
        idx = None
    if not idx:
        return pool
    idx = [i for i in idx if 0 <= i < pool.shape[0]]
    return pool[idx] if idx else pool
