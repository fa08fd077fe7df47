"""Streaming pose-estimation service (port of
:mod:`pix2pose_tpu.serving.service`).

The reference serves through a ROS node (``ros_kinetic/ros_pix2pose.py``):
detect, estimate per-object poses, optionally ICP-refine with depth
(``ros:351-360``), publish overlays. :class:`PoseService` is the same
capability without a transport: :meth:`PoseService.process_many` runs all
frames x all objects through the engine in one batch and, with depth,
refines every valid pose of every frame in one refiner call, whose renders
run the CUDA rasterizer kernel on a GPU. ``ServingConfig.load`` reads the
reference's ``ros_config.json`` schema unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.config import EstimatorConfig
from pix2pose_torch.inference.engine import (Pix2PoseEstimator,
                                             stack_object_params)
from pix2pose_torch.serving import viz
from pix2pose_torch.utils import tracing


@dataclasses.dataclass
class ServingConfig:
    """Mirror of the reference ``ros_config.json`` knobs."""

    backbone: str = "paper"
    inlier_th: float = 0.15
    outlier_th: Sequence[float] = (0.1, 0.2, 0.3, 0.4)
    cam_K: np.ndarray = None
    im_width: int = 640
    im_height: int = 480
    obj_labels: Sequence[int] = ()
    target_obj_name: Sequence[int] = ()
    icp: bool = False
    model_scale: float = 0.001
    rgb_topic: str = "/camera/rgb"
    depth_topic: str = "/camera/depth"

    @classmethod
    def load(cls, path: str) -> "ServingConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            backbone=raw.get("backbone", "paper"),
            inlier_th=float(raw.get("inlier_th", 0.15)),
            outlier_th=tuple(raw.get("outlier_th", (0.1, 0.2, 0.3))),
            cam_K=np.asarray(raw["cam_K"], np.float32).reshape(3, 3),
            im_width=int(raw.get("im_width", 640)),
            im_height=int(raw.get("im_height", 480)),
            obj_labels=tuple(raw.get("obj_labels", ())),
            target_obj_name=tuple(raw.get("target_obj_name", ())),
            icp=bool(raw.get("icp", 0)),
            model_scale=float(raw.get("model_scale", 0.001)),
            rgb_topic=raw.get("rgb_topic", "/camera/rgb"),
            depth_topic=raw.get("depth_topic", "/camera/depth"),
        )


@dataclasses.dataclass
class PoseOutput:
    obj_id: int
    R: np.ndarray
    t: np.ndarray
    score: float
    bbox: np.ndarray


@dataclasses.dataclass
class FrameResult:
    poses: list
    detection_image: np.ndarray  # annotated boxes
    pose_image: np.ndarray       # 3D bbox overlays


class PoseService:
    """Transport-agnostic streaming core on one torch device."""

    def __init__(self, cfg: ServingConfig, detector, estimator_model,
                 params_by_obj: dict, obj_params: dict, box_corners: dict,
                 max_det: int = 4, meshes_m: dict | None = None,
                 device="cuda"):
        """Args:
          detector: ``detect(scene_id, im_id, rgb)`` or ``detect(rgb)``.
          estimator_model: the generator ``nn.Module`` (NHWC in/out).
          params_by_obj: {obj_id: state dict of the generator}.
          obj_params: {obj_id: (6,) norm factors (mm)}.
          box_corners: {obj_id: (8, 3) model bbox corners (mm)}.
          meshes_m: optional {obj_id: (verts_m (V, 3), faces (F, 3))};
            enables depth refinement when ``cfg.icp``.
          device: torch device for the model, tensors and the RANSAC
            generator; the model is moved there.
        """
        self.cfg = cfg
        self.detector = detector
        self.device = torch.device(device)
        self.est = Pix2PoseEstimator(
            estimator_model,
            EstimatorConfig(outlier_th=tuple(cfg.outlier_th),
                            inlier_th=cfg.inlier_th,
                            backbone=cfg.backbone),
            device=self.device)
        self.params_by_obj = params_by_obj
        self.obj_params = obj_params
        self.box_corners = box_corners
        self.max_det = max_det
        self.meshes_m = meshes_m or {}
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.frame_count = 0
        self._obj_ids = sorted(params_by_obj)
        self._stacked = stack_object_params(
            [{k: torch.as_tensor(v).to(self.device)
              for k, v in params_by_obj[o].items()}
             for o in self._obj_ids])
        self._stacked_op = np.stack([np.asarray(obj_params[o], np.float32)
                                     for o in self._obj_ids])
        self._cam_k = torch.as_tensor(np.asarray(cfg.cam_K, np.float32),
                                      device=self.device)
        self._mf_refiner = None
        self._mesh_index: dict = {}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def warm_up(self, max_batch: int) -> None:
        """Run the engine once at every batch size up to ``max_batch``, on
        blank frames with no detection and the first object's weights, so
        that what a batch size builds on first use (PnP-RANSAC's CUDA
        graph, one per candidate count) is built before the first request
        and not in its latency. Only on CUDA: on the CPU nothing is built.
        A generator of its own draws the RANSAC sets, so the service's
        draws stay as they were."""
        if self.device.type != "cuda":
            return
        h, w = self.cfg.im_height, self.cfg.im_width
        first = {k: v[:1] for k, v in self._stacked.items()}
        gen = torch.Generator(device=self.device).manual_seed(0)
        for b in range(1, max_batch + 1):
            self.est.estimate_objects_images(
                first, torch.zeros((b, h, w, 3), dtype=torch.uint8,
                                   device=self.device),
                np.zeros((b, 1, self.max_det, 4), np.int32),
                np.zeros((b, 1, self.max_det), bool),
                self._cam_k.expand(b, 3, 3), self._stacked_op[:1], gen)

    def process(self, rgb: np.ndarray, depth: np.ndarray | None = None
                ) -> FrameResult:
        """One frame, overlays drawn: :meth:`process_many` on a batch of
        one."""
        return self.process_many([rgb], None if depth is None else [depth],
                                 want_images=True)[0]

    def _detect(self, rgb):
        try:
            return self.detector.detect(0, self.frame_count, rgb)
        except TypeError:
            return self.detector.detect(rgb)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def process_many(self, rgbs: Sequence[np.ndarray], depths=None,
                     want_images: bool = False) -> list:
        """All frames x all objects through the engine in one batch.

        With ``depths`` (per-frame depth in metres, None entries allowed),
        ``cfg.icp`` and ``meshes_m``, every valid pose of every frame with
        depth is ICP-refined in one further batch. Returns a list of
        :class:`FrameResult` (images None unless ``want_images``)."""
        obj_ids = self._obj_ids
        n_obj = len(obj_ids)
        b = len(rgbs)
        dets_per_frame = [self._detect(rgb) for rgb in rgbs]
        self.frame_count += b
        bboxes = np.zeros((b, n_obj, self.max_det, 4), np.int32)
        valid = np.zeros((b, n_obj, self.max_det), bool)
        kept: dict[tuple, object] = {}
        for bi, dets in enumerate(dets_per_frame):
            slot = {o: 0 for o in obj_ids}
            for d in dets:
                if self.cfg.target_obj_name and \
                        d.obj_id not in self.cfg.target_obj_name:
                    continue
                if d.obj_id not in self.params_by_obj:
                    continue
                oi = obj_ids.index(d.obj_id)
                si = slot[d.obj_id]
                if si >= self.max_det:
                    continue
                bboxes[bi, oi, si] = d.bbox
                valid[bi, oi, si] = True
                kept[(bi, oi, si)] = d
                slot[d.obj_id] = si + 1
        if tracing.enabled():
            # the slots the engine runs, and those holding a detection
            tracing.count("service.slots", valid.size)
            tracing.count("service.detections", int(valid.sum()))

        imgs = torch.as_tensor(np.stack(rgbs), device=self.device)
        cam_ks = self._cam_k.expand(b, 3, 3)
        est = self.est.estimate_objects_images(
            self._stacked, imgs, bboxes, valid, cam_ks, self._stacked_op,
            self._gen)
        out_R = est.R.cpu().numpy()
        out_t = est.t.cpu().numpy()
        out_valid = est.valid.cpu().numpy()
        out_frac = est.frac_inlier.cpu().numpy()

        refined = {}
        if depths is not None and self.cfg.icp and self.meshes_m \
                and any(d is not None for d in depths):
            refined = self._batch_refine(depths, out_R, out_t, out_valid,
                                         kept, obj_ids, rgbs[0].shape[:2])

        results = []
        for bi in range(b):
            det_img = rgbs[bi].copy() if want_images else None
            pose_img = rgbs[bi].copy() if want_images else None
            poses = []
            for oi, obj_id in enumerate(obj_ids):
                for si in range(self.max_det):
                    d = kept.get((bi, oi, si))
                    if d is None or not out_valid[bi, oi, si]:
                        continue
                    R, t = refined.get((bi, oi, si),
                                       (out_R[bi, oi, si],
                                        out_t[bi, oi, si]))
                    score = d.score * max(float(out_frac[bi, oi, si]), 0.0)
                    poses.append(PoseOutput(obj_id=obj_id, R=R, t=t,
                                            score=score, bbox=d.bbox))
                    if want_images:
                        viz.draw_detection_box(det_img, d.bbox, copy=False)
                        if obj_id in self.box_corners:
                            viz.draw_pose_box(
                                pose_img, self.box_corners[obj_id], R, t,
                                self.cfg.cam_K, copy=False)
            results.append(FrameResult(poses=poses, detection_image=det_img,
                                       pose_image=pose_img))
        return results

    # ------------------------------------------------------------------
    def _ensure_mf_refiner(self, im_hw):
        if self._mf_refiner is None:
            from pix2pose_torch.eval.icp_refine import (
                make_multiframe_icp_refiner, stack_meshes)

            ids = sorted(self.meshes_m)
            self._mesh_index = {o: i for i, o in enumerate(ids)}
            sv, sf = stack_meshes([self.meshes_m[o] for o in ids],
                                  max_faces=40000)
            self._mf_refiner = make_multiframe_icp_refiner(
                sv, sf, im_hw[0], im_hw[1], device=self.device)
        return self._mf_refiner

    def _sensor_prep(self, depths):
        """Despeckle, backproject and normals of (B, H, W) depth."""
        from pix2pose_torch.ops import geometry

        depths = geometry.despeckle_depth(depths)
        return (depths, geometry.backproject(depths, self._cam_k),
                geometry.normals_from_depth(depths, self._cam_k))

    def _batch_refine(self, depths, out_R, out_t, out_valid, kept, obj_ids,
                      im_hw):
        """Every valid (frame, object, slot) hypothesis with a mesh and
        depth, refined together. Returns {(bi, oi, si): (R, t)} for the
        hypotheses the refiner accepted."""
        refine = self._ensure_mf_refiner(im_hw)
        h, w = im_hw
        b = len(depths)
        depth_stack = np.zeros((b, h, w), np.float32)
        has_depth = np.zeros(b, bool)
        for bi, dm in enumerate(depths):
            if dm is not None:
                depth_stack[bi] = np.asarray(dm, np.float32)
                has_depth[bi] = True

        hyps = [(bi, oi, si, d) for (bi, oi, si), d in sorted(kept.items())
                if has_depth[bi] and obj_ids[oi] in self._mesh_index
                and out_valid[bi, oi, si]]
        if not hyps:
            return {}
        n_h = len(hyps)
        obj_idx = np.zeros(n_h, np.int64)
        frame_idx = np.zeros(n_h, np.int64)
        rs = np.zeros((n_h, 3, 3), np.float32)
        ts = np.zeros((n_h, 3), np.float32)
        masks = np.zeros((n_h, h, w), bool)
        for i, (bi, oi, si, d) in enumerate(hyps):
            obj_idx[i] = self._mesh_index[obj_ids[oi]]
            frame_idx[i] = bi
            rs[i] = out_R[bi, oi, si]
            ts[i] = out_t[bi, oi, si]
            dm_ok = depth_stack[bi] > 0.2
            masks[i] = (d.mask & dm_ok) if d.mask is not None else dm_ok

        dev = self.device
        dj, tgt_pts, tgt_normals = self._sensor_prep(
            torch.as_tensor(depth_stack, device=dev))
        ref = refine(obj_idx, frame_idx, torch.as_tensor(rs, device=dev),
                     torch.as_tensor(ts, device=dev), self._cam_k,
                     torch.as_tensor(masks, device=dev), dj, tgt_pts,
                     tgt_normals)
        ok = ref.ok.cpu().numpy()
        R = ref.R.cpu().numpy()
        t = ref.t_mm.cpu().numpy()
        return {(bi, oi, si): (R[i], t[i])
                for i, (bi, oi, si, _) in enumerate(hyps) if ok[i]}


class RosAdapter:
    """The reference node's ROS transport over a :class:`PoseService`:
    its topics (``cfg.rgb_topic`` and ``cfg.depth_topic`` in,
    ``/pix2pose/detected_object`` and ``/pix2pose/object_pose`` out) and
    its unsubscribe-while-busy backpressure (``ros_pix2pose.py:274-284,
    375-388``): the RGB subscriber is dropped while a frame is processed,
    so frames that arrive meanwhile are not taken, and subscribed again
    after the frame's two images are published. Each frame goes through
    :meth:`PoseService.process` with the newest depth (mm -> m). Needs
    ``rospy``, ``ros_numpy`` and ``sensor_msgs``, imported by
    :meth:`spin`."""

    DETECTION_TOPIC = "/pix2pose/detected_object"
    POSE_TOPIC = "/pix2pose/object_pose"

    def __init__(self, service: PoseService):
        self.service = service

    def spin(self):
        import ros_numpy
        import rospy
        from sensor_msgs.msg import Image

        cfg = self.service.cfg
        rospy.init_node("pix2pose_torch")
        pub_det = rospy.Publisher(self.DETECTION_TOPIC, Image, queue_size=1)
        pub_pose = rospy.Publisher(self.POSE_TOPIC, Image, queue_size=1)
        state = {"sub": None, "depth": None}

        def on_depth(msg):
            state["depth"] = ros_numpy.numpify(msg).astype(
                np.float32) / 1000.0

        def on_rgb(msg):
            state["sub"].unregister()  # backpressure (``ros:275``)
            rgb = ros_numpy.numpify(msg)[..., :3]
            res = self.service.process(rgb, state["depth"])
            pub_det.publish(ros_numpy.msgify(
                Image, res.detection_image, encoding="rgb8"))
            pub_pose.publish(ros_numpy.msgify(
                Image, res.pose_image, encoding="rgb8"))
            state["sub"] = rospy.Subscriber(cfg.rgb_topic, Image, on_rgb,
                                            queue_size=1)

        rospy.Subscriber(cfg.depth_topic, Image, on_depth, queue_size=1)
        state["sub"] = rospy.Subscriber(cfg.rgb_topic, Image, on_rgb,
                                        queue_size=1)
        rospy.spin()
