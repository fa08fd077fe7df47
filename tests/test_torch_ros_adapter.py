"""pix2pose_torch ``RosAdapter`` with in-process stand-ins for ``rospy``
/ ``ros_numpy`` / ``sensor_msgs`` (``torch_ros_loopback.py``), against
the JAX adapter on the same stand-ins, on ``tests/test_torch_serving.py``'s
services and frames (the oracle generator on analytic cube scenes at
480x640 with exact depth, ICP on). Published images and poses are held
bit for bit against ``process`` of a fresh twin service: the same frames
and seeds on one device."""

import numpy as np
import torch

from pix2pose_tpu.ops import rasterizer as jrast
from pix2pose_torch.serving import ServingConfig
from pix2pose_torch.utils import synthetic as tsyn
from synthetic import CAM_K, pose_with_euler, xyz_scene
from test_torch_serving import _services
from torch_ros_loopback import LoopbackRos

torch.set_num_threads(1)


def _frames():
    verts, faces = tsyn.cube_mesh(40.0)
    frames = []
    for i in range(2):
        R, t = pose_with_euler(yaw=0.25 + 0.5 * i, tx=15.0 * i)
        rgb, _, _ = xyz_scene(R, t)
        depth_m, _ = jrast.render_depth(verts / 1000.0, faces, R,
                                        t / 1000.0, CAM_K, 480, 640)
        frames.append((rgb, np.asarray(depth_m), R, t))
    return frames


def test_ros_adapter_over_loopback_modules():
    """``RosAdapter`` with stand-ins for ``rospy`` / ``ros_numpy`` /
    ``sensor_msgs`` (``tests/torch_ros_loopback.py``): the JAX adapter's
    topics and subscriptions; an RGB frame that arrives while one is being
    processed is not taken (the subscriber is dropped while busy) and the
    subscriber is back after each frame; the published images, and the
    poses of each frame, equal ``process`` of a fresh twin service on the
    same frames and depths (mm in, metres out)."""
    from pix2pose_tpu.serving.service import RosAdapter as JRosAdapter
    from pix2pose_torch.serving import RosAdapter

    frames = _frames()
    cfg = ServingConfig()
    script = []
    for rgb, depth, _, _ in frames:
        script += [(cfg.depth_topic, (depth * 1000.0).astype(np.float32)),
                   (cfg.rgb_topic, rgb)]
    runs = {}
    for name, (svc, adapter) in {
            "torch": (_services()[1], RosAdapter),
            "jax": (_services()[0], JRosAdapter)}.items():
        bus, seen = LoopbackRos(script), []
        process = svc.process

        def busy_process(rgb, depth, process=process, bus=bus, seen=seen):
            if not seen:  # a frame that arrives while this one runs
                bus.deliver(cfg.rgb_topic, frames[1][0])
            seen.append(process(rgb, depth))
            return seen[-1]

        svc.process = busy_process
        with bus.installed():
            adapter(svc).spin()
        runs[name] = bus, seen
    bus, seen = runs["torch"]
    jbus, _ = runs["jax"]
    assert bus.node == "pix2pose_torch"
    assert bus.subscribe_log == jbus.subscribe_log == [
        cfg.depth_topic, cfg.rgb_topic, cfg.rgb_topic, cfg.rgb_topic]
    assert bus.dropped == jbus.dropped == {cfg.rgb_topic: 1}
    assert len(bus.subscribers[cfg.rgb_topic]) == 1
    assert set(bus.published) == set(jbus.published) == {
        RosAdapter.DETECTION_TOPIC, RosAdapter.POSE_TOPIC}
    twin = _services()[1]
    for i, (rgb, depth, _, _) in enumerate(frames):
        ref = twin.process(rgb, (depth * 1000.0).astype(np.float32)
                           / 1000.0)
        assert np.array_equal(bus.published[RosAdapter.DETECTION_TOPIC][i],
                              ref.detection_image)
        assert np.array_equal(bus.published[RosAdapter.POSE_TOPIC][i],
                              ref.pose_image)
        assert len(seen[i].poses) == len(ref.poses) == 1
        np.testing.assert_array_equal(seen[i].poses[0].R, ref.poses[0].R)
        np.testing.assert_array_equal(seen[i].poses[0].t, ref.poses[0].t)
