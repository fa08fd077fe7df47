"""Statistical parity of the port's PnP-RANSAC with its own sampler: the
solver-level corruption sweep of ``tools/pnp_sweep.py`` (its
``make_case``: a 60 mm cube surface seen at 450-800 mm, about half the
slots valid, PROSAC quality ranking inliers above outliers noisily), at
the engine's 1024 slots (not the tool's 4096 default), 48 seeds per cell,
one batched call per package (the JAX solver with its threefry keys, the
port with one ``torch.Generator``).

The bar was fixed from a probe of both packages on the CPU at these
settings: the rotation error medians came out 0.0713 (JAX) vs 0.0685 deg
(port) at 0.5 px / 0% outliers and 0.1928 vs 0.1887 deg at 1 px / 25%,
within 4% of each other, and the port's median moved by less than 4%
across three generator seeds. The translation medians matched within 3%,
but at 1 px / 25% moved by up to 23% across generator seeds (0.657-0.782
mm against JAX's 0.637). So the port's median must lie within 15% of
JAX's for rotation and within 30% for translation. The noisy 2 px / 50%
cell is not gated (its p90 is noisy both ways).
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

from pix2pose_tpu.ops import pnp as jpnp
from pix2pose_torch.ops import pnp as tpnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from pnp_sweep import make_case  # noqa: E402

torch.set_num_threads(1)
SEEDS = 48
SLOTS = 1024
KW = dict(iters=32, refine_iters=8, hyp_polish_iters=3, select_stride=4)


def medians(R, t, cases):
    """Median rotation error (deg) and translation error (mm)."""
    rot = [np.degrees(np.arccos(np.clip(
        (np.trace(np.asarray(R[i]) @ c[4].T) - 1) / 2, -1, 1)))
        for i, c in enumerate(cases)]
    tr = [np.linalg.norm(np.asarray(t[i]) - c[5]) for i, c in
          enumerate(cases)]
    return float(np.median(rot)), float(np.median(tr))


@pytest.mark.parametrize("noise_px,outlier_frac", [(0.5, 0.0), (1.0, 0.25)])
def test_sweep_medians_match_jax(noise_px, outlier_frac):
    cases = [make_case(s, noise_px, outlier_frac, n=SLOTS)
             for s in range(SEEDS)]
    obj, img, valid, quality = (np.stack([c[k] for c in cases])
                                for k in range(4))
    K = cases[0][6]
    ref = jax.jit(lambda o, i, v, k, q: jpnp.pnp_ransac_batch(
        o, i, v, K, k, q, **KW))(obj, img, valid,
                                 jax.random.split(jax.random.PRNGKey(1234),
                                                  SEEDS), quality)
    got = tpnp.pnp_ransac_batch(
        *(torch.from_numpy(x) for x in (obj, img, valid)),
        torch.from_numpy(K), torch.Generator().manual_seed(0),
        torch.from_numpy(quality), **KW)
    assert bool(got.ok.all()) and bool(np.asarray(ref.ok).all())
    rot_j, t_j = medians(ref.R, ref.t, cases)
    rot_t, t_t = medians(got.R.numpy(), got.t.numpy(), cases)
    assert abs(rot_t - rot_j) <= 0.15 * rot_j, (rot_t, rot_j)
    assert abs(t_t - t_j) <= 0.30 * t_j, (t_t, t_j)
    # and both are small: sub-0.3-degree, sub-millimetre poses
    assert max(rot_t, rot_j) < 0.3 and max(t_t, t_j) < 1.0
