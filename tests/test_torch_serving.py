"""pix2pose_torch serving path (PoseService with ICP, PoseServer) mirrored
against the JAX package's ``depth_service`` scene: the oracle generator
on analytic cube scenes at 480x640 with exact depth.

Same assertions as the JAX package's serving tests, and port vs JAX poses
within 2 mm and 1 degree (the two draw different RANSAC samples, so the
poses agree to pose-error tolerance, not bit for bit). The TCP server is
tested in ``test_torch_server.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.inference.detector import Detection as JDetection
from pix2pose_tpu.ops import rasterizer as jrast
from pix2pose_tpu.serving import PoseService as JPoseService
from pix2pose_tpu.serving import ServingConfig as JServingConfig
from pix2pose_torch.serving import PoseService, ServingConfig
from pix2pose_torch.serving.viz import bbox_corners
from pix2pose_torch.utils import synthetic as tsyn
from synthetic import CAM_K, OracleGenerator, pose_with_euler, xyz_scene

torch.set_num_threads(1)


class JaxPerFrameDetector(tsyn.PerFrameDetector):
    def detect(self, rgb):
        return [JDetection(d.bbox, d.obj_id, d.score, d.mask)
                for d in super().detect(rgb)]


def _services():
    verts, faces = tsyn.cube_mesh(40.0)
    obj_param = np.array([40, 40, 40, 0, 0, 0], np.float32)
    jmodel = OracleGenerator()
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    jsvc = JPoseService(
        JServingConfig(cam_K=np.asarray(CAM_K), outlier_th=(0.1, 0.2, 0.3),
                       inlier_th=0.1, icp=True),
        JaxPerFrameDetector(), jmodel, {1: jparams}, {1: obj_param},
        {1: bbox_corners(verts)}, meshes_m={1: (verts / 1000.0, faces)})
    tmodel = tsyn.OracleGenerator()
    tsvc = PoseService(
        ServingConfig(cam_K=np.asarray(CAM_K), outlier_th=(0.1, 0.2, 0.3),
                      inlier_th=0.1, icp=True),
        tsyn.PerFrameDetector(), tmodel, {1: tmodel.state_dict()},
        {1: obj_param}, {1: bbox_corners(verts)},
        meshes_m={1: (verts / 1000.0, faces)}, device="cpu")
    return jsvc, tsvc, verts, faces


@pytest.fixture(scope="module")
def depth_scenes():
    """Both services and the JAX test's two frames (rgb, depth, R, t), run
    through both packages with and without depth."""
    jsvc, tsvc, verts, faces = _services()
    frames = []
    for i in range(2):
        R, t = pose_with_euler(yaw=0.25 + 0.5 * i, tx=15.0 * i)
        rgb, _, _ = xyz_scene(R, t)
        depth_m, _ = jrast.render_depth(verts / 1000.0, faces, R,
                                        t / 1000.0, CAM_K, 480, 640)
        frames.append((rgb, np.asarray(depth_m), R, t))
    rgbs = [f[0] for f in frames]
    depths = [f[1] for f in frames]
    runs = {"torch": (tsvc.process_many(rgbs),
                      tsvc.process_many(rgbs, depths=depths)),
            "jax": (jsvc.process_many(rgbs),
                    jsvc.process_many(rgbs, depths=depths))}
    return tsvc, frames, runs


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_process_many_batched_icp_refinement(depth_scenes):
    _, frames, runs = depth_scenes
    plain, refined = runs["torch"]
    assert len(refined) == len(frames)
    for res_p, res_r, (_, _, R, t) in zip(plain, refined, frames):
        assert len(res_r.poses) == 1
        err_p = np.linalg.norm(res_p.poses[0].t - t)
        err_r = np.linalg.norm(res_r.poses[0].t - t)
        assert err_r <= err_p + 1.0
        assert err_r < 0.02 * t[2]
    deltas = [np.linalg.norm(a.poses[0].t - b.poses[0].t)
              for a, b in zip(plain, refined)]
    assert max(deltas) > 1e-6


@pytest.mark.parametrize("which", [0, 1], ids=["rgb", "rgbd"])
def test_poses_agree_with_jax(depth_scenes, which):
    _, _, runs = depth_scenes
    for res_t, res_j in zip(runs["torch"][which], runs["jax"][which]):
        assert len(res_t.poses) == len(res_j.poses) == 1
        pt, pj = res_t.poses[0], res_j.poses[0]
        assert np.linalg.norm(pt.t - np.asarray(pj.t)) < 2.0
        assert _rot_deg(pt.R, pj.R) < 1.0


def test_process_many_mixed_depth_batch(depth_scenes):
    svc, frames, _ = depth_scenes
    out = svc.process_many([f[0] for f in frames],
                           depths=[None, frames[1][1]])
    assert len(out) == 2 and all(len(r.poses) == 1 for r in out)


def test_process_single_frame_draws_overlays(depth_scenes):
    svc, frames, runs = depth_scenes
    rgb, depth, R, t = frames[0]
    res = svc.process(rgb, depth)
    assert len(res.poses) == 1
    assert np.linalg.norm(res.poses[0].t - t) < 0.02 * t[2]
    assert (res.pose_image != rgb).any()
    assert (res.detection_image != rgb).any()
