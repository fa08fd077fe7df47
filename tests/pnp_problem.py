"""Seeded PnP problems shared by the PnP tests on the CPU and on the card
(imports neither jax nor the JAX package)."""

import numpy as np
from scipy.spatial.transform import Rotation

CAM_K = np.array([[572.4, 0.0, 325.3], [0.0, 573.6, 242.0],
                  [0.0, 0.0, 1.0]], np.float32)
# the serving configuration's solver settings
KW = dict(iters=32, reproj_px=5.0, min_pts=6, refine_iters=8,
          select_stride=4, hyp_polish_iters=3)


def problem(seed, n=1024, n_valid=600, outlier=0.2, noise=0.5):
    """Grid-like correspondences of a 40 mm cube surface at 600 mm with
    pixel noise, gross outliers and a partial validity mask:
    ``(obj (n, 3), uv (n, 2), valid (n,), quality (n,))``."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, 3, n)
    pts = rng.uniform(-40, 40, (n, 3))
    pts[np.arange(n), face] = np.sign(rng.normal(size=n)) * 40.0
    ang = rng.uniform(-0.6, 0.6, 3)
    R = Rotation.from_rotvec(ang).as_matrix()
    t = np.array([rng.uniform(-30, 30), rng.uniform(-30, 30),
                  rng.uniform(500, 700)])
    p = pts @ R.T + t
    uv = np.stack([CAM_K[0, 0] * p[:, 0] / p[:, 2] + CAM_K[0, 2],
                   CAM_K[1, 1] * p[:, 1] / p[:, 2] + CAM_K[1, 2]], 1)
    uv += rng.normal(0, noise, uv.shape)
    bad = rng.random(n) < outlier
    uv[bad] += rng.uniform(-60, 60, (bad.sum(), 2))
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    quality = -rng.uniform(0, 0.1, n)
    return (pts.astype(np.float32), uv.astype(np.float32), valid,
            quality.astype(np.float32))
