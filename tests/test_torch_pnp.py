"""pix2pose_torch PnP-RANSAC against the JAX package. Fed JAX's own
hypothesis index sets (threefry bits cannot be reproduced in torch), it
must count the same inliers, with R within 1e-4 (Frobenius) and t within
1e-4 relative. The small-matrix solvers are in ``test_torch_smallmat.py``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.ops import pnp as jpnp
from pix2pose_torch.ops import pnp as tpnp
from pix2pose_torch.ops.pnp import PnPResult
from pnp_problem import CAM_K, KW, problem

torch.set_num_threads(1)


def _jax_index_sets(key, valid, quality, iters):
    key_a, key_b = jax.random.split(key)
    n_min = iters // 2
    idx_a = jpnp._sample_minimal_sets(key_a, jnp.asarray(valid), n_min, 6,
                                      jnp.asarray(quality))
    idx_b = jpnp._sample_minimal_sets(key_b, jnp.asarray(valid),
                                      iters - n_min, 12, jnp.asarray(quality))
    return idx_a, idx_b


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.n_inliers.numpy(),
                                  np.asarray(ref.n_inliers))
    dR = np.linalg.norm(got.R.numpy() - np.asarray(ref.R), axis=(-2, -1))
    assert dR.max() < 1e-4, dR
    t_ref = np.asarray(ref.t)
    dt = np.linalg.norm(got.t.numpy() - t_ref, axis=-1) \
        / np.maximum(np.linalg.norm(t_ref, axis=-1), 1e-6)
    assert dt.max() < 1e-4, dt


@pytest.fixture(scope="module")
def jax_batch():
    """Four candidates solved by the JAX solver in one jitted call, with
    the hypothesis index sets it drew. Candidate 2 has too few valid
    points (the bail-out: identity pose, n_inliers -1)."""
    probs = [problem(s, n_valid=nv) for s, nv in
             ((0, 600), (2, 300), (3, 5), (4, 1024))]
    obj, img, valid, quality = (np.stack(x) for x in zip(*probs))
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    ref = jax.jit(functools.partial(jpnp.pnp_ransac_batch, **KW))(
        obj, img, valid, CAM_K, keys, quality)
    draw = jax.jit(jax.vmap(lambda k, v, q: _jax_index_sets(
        k, v, q, KW["iters"])))
    sets = list(zip(*[np.asarray(a) for a in draw(keys, valid, quality)]))
    idx = (np.stack([s[0] for s in sets]), np.stack([s[1] for s in sets]))
    assert list(np.asarray(ref.ok)) == [True, True, False, True]
    return (obj, img, valid, quality), idx, ref


def test_pnp_ransac_with_jax_index_sets(jax_batch):
    (obj, img, valid, quality), idx, ref = jax_batch
    assert int(ref.n_inliers[0]) > 300
    got = tpnp.pnp_ransac(torch.from_numpy(obj[0]), torch.from_numpy(img[0]),
                          torch.from_numpy(valid[0]),
                          torch.from_numpy(CAM_K),
                          quality=torch.from_numpy(quality[0]),
                          sample_idx=(idx[0][0], idx[1][0]), **KW)
    _assert_same(PnPResult(*(x[None] for x in got)),
                 jax.tree_util.tree_map(lambda x: x[:1], ref))


def test_pnp_ransac_batch_with_jax_index_sets(jax_batch):
    (obj, img, valid, quality), idx, ref = jax_batch
    got = tpnp.pnp_ransac_batch(
        torch.from_numpy(obj), torch.from_numpy(img),
        torch.from_numpy(valid), torch.from_numpy(CAM_K),
        quality=torch.from_numpy(quality), sample_idx=idx, **KW)
    _assert_same(got, ref)


def test_pnp_ransac_own_sampler_recovers_pose(jax_batch):
    """With the torch sampler (no injected sets) the solver still lands on
    the JAX solution's pose to pose-error tolerance."""
    (obj, img, valid, quality), _, ref = jax_batch
    gen = torch.Generator().manual_seed(0)
    got = tpnp.pnp_ransac(torch.from_numpy(obj[0]), torch.from_numpy(img[0]),
                          torch.from_numpy(valid[0]),
                          torch.from_numpy(CAM_K), gen,
                          torch.from_numpy(quality[0]), **KW)
    assert bool(got.ok)
    assert np.linalg.norm(got.t.numpy() - np.asarray(ref.t[0])) < 2.0
    cos = (np.trace(got.R.numpy().T @ np.asarray(ref.R[0])) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0


def test_pnp_ransac_batch_generator_per_group(jax_batch):
    """A sequence of generators, one per equal group of candidates, gives
    each group the result of a call on that group alone with its
    generator (candidates 0-1 and 2-3); a count that does not divide the
    candidates raises."""
    (obj, img, valid, quality), _, _ = jax_batch
    args = [torch.from_numpy(x) for x in (obj, img, valid)]
    k, q = torch.from_numpy(CAM_K), torch.from_numpy(quality)

    def gens():
        return [torch.Generator().manual_seed(s) for s in (11, 12)]

    got = tpnp.pnp_ransac_batch(*args, k, gens(), q, **KW)
    for g, rows in zip(gens(), (slice(0, 2), slice(2, 4))):
        alone = tpnp.pnp_ransac_batch(*(a[rows] for a in args), k, g,
                                      q[rows], **KW)
        for x, y in zip(got, alone):
            assert torch.equal(x[rows], y)
    with pytest.raises(ValueError):
        tpnp.pnp_ransac_batch(*args, k, gens() + gens()[:1], q, **KW)


def test_compaction_matches_jax_and_engine_keeps_the_pose(jax_batch):
    """``compact_correspondences``: the kept points, their packed order,
    counts and quality equal the JAX function's exactly, for a cap below
    and above each candidate's valid count (600, 300, 5, 1024 valid of
    1024). Then the engine with ``max_pnp_points=1024`` on the analytic
    cube scene (the oracle generator) against the full grid, with
    ``tests/test_engine.py``'s bars: valid, rotation within 3 deg, t
    within 2% of t_z, frac_inlier within 15% of the full grid's."""
    from pix2pose_torch.config import EstimatorConfig
    from pix2pose_torch.inference.engine import Pix2PoseEstimator
    from pix2pose_torch.utils import synthetic as tsyn
    from synthetic import CAM_K as SCENE_K
    from synthetic import pose_with_euler, xyz_scene

    (obj, img, valid, quality), _, _ = jax_batch
    for cap in (256, 512):
        ref = jax.vmap(lambda o, i, v, q: jpnp.compact_correspondences(
            o, i, v, cap, q))(obj, img, valid, quality)
        got = tpnp.compact_correspondences(
            *(torch.from_numpy(x) for x in (obj, img, valid)), cap,
            torch.from_numpy(quality))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert [int(n) for n in got[5]] == [512, 300, 5, 512]

    R, t = pose_with_euler()
    rgb, obj_param, hit = xyz_scene(R, t)
    vs, us = np.nonzero(hit)
    bboxes = np.stack([np.array([vs.min(), us.min(), vs.max() + 1,
                                 us.max() + 1], np.int32),
                       np.zeros(4, np.int32)])
    out = {}
    for cap in (None, 1024):
        cfg = EstimatorConfig(outlier_th=(0.1, 0.2, 0.3), inlier_th=0.1,
                              pnp_stride=2, max_pnp_points=cap)
        est = Pix2PoseEstimator(tsyn.OracleGenerator(), cfg, device="cpu")
        out[cap] = est(None, rgb, bboxes, np.array([True, False]), SCENE_K,
                       obj_param, torch.Generator().manual_seed(1))
    full, comp = out[None], out[1024]
    assert bool(comp.valid[0]) and not bool(comp.valid[1])
    cos = (np.trace(comp.R[0].numpy().T @ R) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 3.0
    assert np.linalg.norm(comp.t[0].numpy() - t) < 0.02 * t[2]
    f_full, f_comp = float(full.frac_inlier[0]), float(comp.frac_inlier[0])
    assert abs(f_comp - f_full) < 0.15 * max(f_full, 1e-6)


def _valid_distinct(idx, valid, k):
    """Every index of every set points at a valid point, and a set's
    indices are distinct wherever at least ``k`` points are valid."""
    idx, valid = np.asarray(idx), np.asarray(valid)
    assert np.take_along_axis(valid, idx.reshape(len(idx), -1), 1).all()
    for c, sets in enumerate(idx):
        if valid[c].sum() >= k:
            assert all(len(set(s)) == k for s in sets.tolist())


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_quality", [True, False])
def test_eager_draws_then_body_equal_one_call(jax_batch, groups,
                                              with_quality):
    """The split of ``pnp_ransac_batch``: ``_draw_index_sets`` gives sets
    of the shapes and kinds the JAX solver draws (valid points only,
    distinct within a set with enough valid points), with one generator
    or one per group, with and without PROSAC quality; a group's sets are
    those drawn on that group alone; and the one call equals the call fed
    those sets through ``sample_idx``, the path held to the JAX solver
    above, bit for bit. On the CPU no graph is captured or replayed."""
    (obj, img, valid, quality), jax_idx, _ = jax_batch
    obj, img, valid, quality = (torch.from_numpy(x)
                                for x in (obj, img, valid, quality))
    q = quality if with_quality else None
    k = torch.from_numpy(CAM_K)
    seeds = (21, 22)[:groups]

    def gens():
        g = [torch.Generator().manual_seed(s) for s in seeds]
        return g if groups > 1 else g[0]

    idx = tpnp._draw_index_sets(gens(), valid, q, KW["iters"], 6, 12)
    for got, ref, size in zip(idx, jax_idx, (6, 12)):
        assert got.shape == ref.shape and got.dtype == torch.int64
        _valid_distinct(ref, valid, size)
        _valid_distinct(got, valid, size)
    if groups > 1:
        for g, rows in zip(gens(), (slice(0, 2), slice(2, 4))):
            alone = tpnp._draw_index_sets(
                g, valid[rows], None if q is None else q[rows],
                KW["iters"], 6, 12)
            for x, y in zip(idx, alone):
                assert torch.equal(x[rows], y)
    before = (tpnp.pnp_ransac_batch.graph_captures,
              tpnp.pnp_ransac_batch.graph_replays)
    one = tpnp.pnp_ransac_batch(obj, img, valid, k, gens(), q, **KW)
    fed = tpnp.pnp_ransac_batch(obj, img, valid, k, sample_idx=idx, **KW)
    assert list(one.ok) == [True, True, False, True]
    for x, y in zip(one, fed):
        assert torch.equal(x, y)
    assert (tpnp.pnp_ransac_batch.graph_captures,
            tpnp.pnp_ransac_batch.graph_replays) == before
