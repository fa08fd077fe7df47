"""pix2pose_torch depth geometry, point-to-plane ICP and the multi-frame
refiner against the JAX package on the same inputs.

Tolerances: geometry at 1e-5 (fp32 convolutions and sums in different
orders; the despeckle median is a selection and must match exactly),
except normals of an inpainted and blurred map at 1e-4 (see there); ICP
on identical clouds to 1e-4 in R and 1e-5 m in t; the refiner from a
10 mm / 5 degree perturbed start to 0.1 degree and 0.5 mm (the JAX package
renders with its XLA scan rasterizer on CPU, the port with the binned
one, so silhouettes may differ by tie-broken pixels)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.eval import icp_refine as jref
from pix2pose_tpu.ops import geometry as jgeo
from pix2pose_tpu.ops import icp as jicp
from pix2pose_tpu.ops import rasterizer as jrast
from pix2pose_torch.eval import icp_refine as tref
from pix2pose_torch.ops import geometry as tgeo
from pix2pose_torch.ops import icp as ticp
from pix2pose_torch.utils.synthetic import CAM_K, cube_mesh, pose_with_euler

torch.set_num_threads(1)

K_SMALL = np.array([[90.0, 0, 31.5], [0, 92.0, 24.0], [0, 0, 1]], np.float32)


def _depth_map(seed=0, h=48, w=64):
    """Tilted plane with a bump, holes and speckle (metres)."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 0.6 + 0.002 * u - 0.001 * v \
        + 0.03 * np.exp(-((u - 30) ** 2 + (v - 20) ** 2) / 60.0)
    d[rng.random((h, w)) < 0.05] = 0.0
    sp = rng.random((h, w)) < 0.04
    d[sp] += rng.uniform(-0.3, 0.3, sp.sum())
    return d.astype(np.float32)


def test_geometry_matches_jax():
    d = _depth_map()
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    kt = torch.from_numpy(K_SMALL)
    np.testing.assert_allclose(
        tgeo.backproject(dt, kt).numpy(),
        np.asarray(jgeo.backproject(dj, jnp.asarray(K_SMALL))), atol=1e-5)
    np.testing.assert_array_equal(tgeo.despeckle_depth(dt).numpy(),
                                  np.asarray(jgeo.despeckle_depth(dj)))
    np.testing.assert_allclose(tgeo.inpaint_depth(dt).numpy(),
                               np.asarray(jgeo.inpaint_depth(dj)), atol=1e-5)
    np.testing.assert_allclose(tgeo.gaussian_blur(dt).numpy(),
                               np.asarray(jgeo.gaussian_blur(dj)), atol=1e-5)
    clean = tgeo.despeckle_depth(dt)
    cj = jnp.asarray(clean.numpy())
    np.testing.assert_allclose(
        tgeo.normals_from_depth(clean, kt, refine=False).numpy(),
        np.asarray(jgeo.normals_from_depth(cj, jnp.asarray(K_SMALL),
                                           refine=False)), atol=1e-5)
    # after inpaint + blur, normals difference depths that agree to ~1e-7
    # and scale the difference by ~fx/depth: held at 1e-4
    np.testing.assert_allclose(
        tgeo.normals_from_depth(clean, kt).numpy(),
        np.asarray(jgeo.normals_from_depth(cj, jnp.asarray(K_SMALL))),
        atol=1e-4)
    # a leading batch axis gives the per-map results
    both = tgeo.normals_from_depth(torch.stack([clean, clean * 1.1]), kt)
    np.testing.assert_allclose(both[0].numpy(),
                               tgeo.normals_from_depth(clean, kt).numpy(),
                               atol=1e-4)


def test_icp_point_to_plane_matches_jax():
    """Same clouds in both: a dense surface patch and a rigidly moved,
    partial, noisy copy with gross outliers."""
    rng = np.random.default_rng(1)
    d = _depth_map(seed=1, h=64, w=64)
    d[d <= 0] = 0.6
    d = np.asarray(jgeo.despeckle_depth(jnp.asarray(d)))
    pts = np.asarray(jgeo.backproject(jnp.asarray(d), jnp.asarray(K_SMALL)))
    nrm = np.asarray(jgeo.normals_from_depth(jnp.asarray(d),
                                             jnp.asarray(K_SMALL)))
    ok = d.reshape(-1) > 0
    tgt = pts.reshape(-1, 3)[ok][:2048].astype(np.float32)
    tgt_n = nrm.reshape(-1, 3)[ok][:2048].astype(np.float32)
    from scipy.spatial.transform import Rotation
    dR = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix()
    src = (tgt[::4] - [0.0, 0.0, 0.6]) @ dR.T + [0.004, -0.003, 0.605]
    src = (src + rng.normal(0, 5e-4, src.shape)).astype(np.float32)
    src[:20] += rng.uniform(-0.2, 0.2, (20, 3)).astype(np.float32)
    sv = np.ones(len(src), bool)
    sv[-30:] = False
    ref = jicp.icp_point_to_plane(src, tgt, tgt_n, src_valid=sv, iters=20)
    got = ticp.icp_point_to_plane(torch.from_numpy(src),
                                  torch.from_numpy(tgt),
                                  torch.from_numpy(tgt_n),
                                  src_valid=torch.from_numpy(sv), iters=20)
    assert bool(got.ok) and bool(ref.ok)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-5)
    # fewer than 10 valid source points: flagged, identity
    few = ticp.icp_point_to_plane(torch.from_numpy(src),
                                  torch.from_numpy(tgt),
                                  torch.from_numpy(tgt_n),
                                  src_valid=torch.arange(len(src)) < 5)
    assert not bool(few.ok) and torch.equal(few.R, torch.eye(3))


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_multiframe_refiner_matches_jax():
    """The serving scene (cube at 480x640, exact depth): two hypotheses
    perturbed by 10 mm / 5 degrees, refined by both packages."""
    from scipy.spatial.transform import Rotation

    verts, faces = cube_mesh(40.0)
    R, t = pose_with_euler(yaw=0.25, tx=0.0)
    depth, mask = jrast.render_depth(verts / 1000.0, faces, R, t / 1000.0,
                                     CAM_K, 480, 640)
    depth, mask = np.array(depth), np.array(mask)
    starts = []
    for axis, dt in (([1, 0, 0], [10.0, 0, 0]), ([0, 1, 1], [0, -6.0, 8.0])):
        ax = np.asarray(axis, float) / np.linalg.norm(axis)
        dR = Rotation.from_rotvec(np.radians(5.0) * ax).as_matrix()
        starts.append(((dR @ R).astype(np.float32),
                       (t + np.asarray(dt)).astype(np.float32)))
    rs = np.stack([s[0] for s in starts])
    ts = np.stack([s[1] for s in starts])
    masks = np.stack([mask & (depth > 0.2)] * 2)
    sv, sf = jref.stack_meshes([(verts / 1000.0, faces)])

    dj = jgeo.despeckle_depth(jnp.asarray(depth))
    jout = jref.make_multiframe_icp_refiner(sv, sf, 480, 640)(
        jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32), rs, ts,
        jnp.asarray(CAM_K), masks, dj[None],
        jgeo.backproject(dj, jnp.asarray(CAM_K))[None],
        jgeo.normals_from_depth(dj, jnp.asarray(CAM_K))[None],
        jax.random.split(jax.random.PRNGKey(0), 2))

    kt = torch.from_numpy(CAM_K)
    dt_ = tgeo.despeckle_depth(torch.from_numpy(depth))[None]
    refine = tref.make_multiframe_icp_refiner(sv, sf, 480, 640,
                                             device="cpu")
    tout = refine(np.zeros(2, np.int64), np.zeros(2, np.int64),
                  torch.from_numpy(rs), torch.from_numpy(ts), CAM_K,
                  torch.from_numpy(masks), dt_, tgeo.backproject(dt_, kt),
                  tgeo.normals_from_depth(dt_, kt))
    np.testing.assert_array_equal(tout.ok.numpy(), np.asarray(jout.ok))
    assert tout.ok.all()
    assert int(tout.overflow.sum()) == 0
    for i in range(2):
        assert _rot_deg(tout.R[i].numpy(), jout.R[i]) < 0.1
        assert np.linalg.norm(tout.t_mm[i].numpy()
                              - np.asarray(jout.t_mm[i])) < 0.5
        # and both actually refined toward the truth
        assert np.linalg.norm(tout.t_mm[i].numpy() - t) < 2.0
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0.02)


def test_sample_masked_matches_jax():
    rng = np.random.default_rng(2)
    m = rng.random((3, 5000)) < np.array([[0.5], [0.01], [0.0]])
    got_i, got_v = tref._sample_masked(torch.from_numpy(m), 256)
    for row in range(3):
        ref_i, ref_v = jref._sample_masked(None, jnp.asarray(m[row]), 256)
        np.testing.assert_array_equal(got_i[row].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v[row].numpy(), np.asarray(ref_v))
