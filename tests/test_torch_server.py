"""pix2pose_torch PoseServer over TCP, in front of the port's RGB-D
PoseService (oracle generator, analytic cube scenes at 480x640, depth
rendered by the port). One round trip has the JAX package's PoseClient
talk to the port's PoseServer, so the wire protocol is the same byte for
byte. Poses are held to 5% of the true translation (5 mm floor with depth,
3 mm without), as in the JAX package's serving tests."""

import json

import numpy as np
import pytest
import torch

from pix2pose_tpu.serving import ServingConfig as JServingConfig
from pix2pose_tpu.serving.server import PoseClient as JPoseClient
from pix2pose_torch.ops import rasterizer
from pix2pose_torch.serving import (PoseClient, PoseServer, PoseService,
                                    ServingConfig)
from pix2pose_torch.serving.server import benchmark_concurrent
from pix2pose_torch.serving.viz import bbox_corners
from pix2pose_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
CAM_K = tsyn.CAM_K


@pytest.fixture(scope="module")
def served():
    """The port's depth service and two frames (rgb, depth m, R, t mm)."""
    verts, faces = tsyn.cube_mesh(40.0)
    model = tsyn.OracleGenerator()
    svc = PoseService(
        ServingConfig(cam_K=CAM_K, outlier_th=(0.1, 0.2, 0.3),
                      inlier_th=0.1, icp=True),
        tsyn.PerFrameDetector(), model, {1: model.state_dict()},
        {1: np.array([40, 40, 40, 0, 0, 0], np.float32)},
        {1: bbox_corners(verts)}, meshes_m={1: (verts / 1000.0, faces)},
        device="cpu")
    frames = []
    for i in range(2):
        R, t = tsyn.pose_with_euler(yaw=0.25 + 0.5 * i, tx=15.0 * i)
        rgb, _, _ = tsyn.xyz_scene(R, t)
        depth, _ = rasterizer.render_depth(
            torch.from_numpy(verts / 1000.0), torch.from_numpy(faces),
            torch.from_numpy(R), torch.from_numpy(t / 1000.0), CAM_K, 480,
            640)
        frames.append((rgb, depth.numpy(), R, t))
    return svc, frames


def test_jax_client_talks_to_torch_server(served):
    svc, frames = served
    server = PoseServer(svc, max_batch=4)
    try:
        c = JPoseClient(*server.address)
        rgb, depth, R, t = frames[0]
        out = c.estimate(rgb, depth=depth)
        assert len(out["poses"]) == 1
        np.testing.assert_allclose(out["poses"][0]["t"], t, rtol=0.05,
                                   atol=5.0)
        img = c.estimate(rgb, want_images=True)
        assert img["detection_image"].shape == rgb.shape
        c.close()
    finally:
        server.close()


def test_server_round_trip_and_concurrency(served):
    svc, frames = served
    server = PoseServer(svc, max_batch=4)
    try:
        c = PoseClient(*server.address)
        rgb, _, _, t = frames[1]
        out = c.estimate(rgb)
        np.testing.assert_allclose(out["poses"][0]["t"], t, rtol=0.05,
                                   atol=3.0)
        c.close()
        stats = benchmark_concurrent(server, rgb, n_clients=3, n_frames=2)
        assert stats["frames"] == 6 and stats["fps"] > 0
        assert max(server.frontend.batch_sizes) >= 2
    finally:
        server.close()


def test_serving_config_load_matches_jax(tmp_path):
    path = tmp_path / "ros_config.json"
    path.write_text(json.dumps({
        "cam_K": CAM_K.reshape(-1).tolist(), "icp": 1,
        "outlier_th": [0.2, 0.3], "inlier_th": 0.12, "im_width": 320,
        "obj_labels": [1, 5], "rgb_topic": "/cam/rgb"}))
    got, ref = ServingConfig.load(str(path)), JServingConfig.load(str(path))
    for f in ("backbone", "inlier_th", "outlier_th", "im_width", "im_height",
              "obj_labels", "target_obj_name", "icp", "model_scale",
              "rgb_topic", "depth_topic"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_array_equal(got.cam_K, ref.cam_K)
