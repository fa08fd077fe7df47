"""Detector-protocol adapters around the in-repo detectors (port of
:mod:`pix2pose_tpu.inference.jax_detector`): :class:`TorchDetector` for
the CenterNet detector (``JaxDetector``) and :class:`RetinaNetAdapter`
for the RetinaNet head.

The frame is resized anisotropically to the square training resolution
(the detector trains on fully covered square images, so letterbox padding
would be out of domain): a separable triangle filter that widens when it
downsamples, ``F.interpolate(..., antialias=True)``, which equals
``jax.image.resize(..., "linear")`` within 2e-7 at 480x640 -> 512x512.
The network and the decode run on the device; boxes and masks are
unscaled per axis on the host exactly as the JAX adapter does: boxes
rounded and clipped, boxes under 4 px dropped, each stride-4 instance
mask upsampled with PIL ``BILINEAR`` and thresholded at 127, then ANDed
with its box. The RetinaNet head has no mask head: its adapter emits
box-shaped masks, as the reference's keras-retinanet path does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pix2pose_torch.inference.detector import Detection
from pix2pose_torch.models.detector import decode_detections


def _frame_box(b, sv, su, h, w):
    """A square-input box scaled to the frame, rounded and clipped to
    inclusive pixel bounds; None when under 4 px on a side."""
    bbox = np.array([b[0] * sv, b[1] * su, b[2] * sv, b[3] * su])
    bbox = np.round(np.clip(bbox, [0, 0, 0, 0], [h - 1, w - 1, h - 1, w - 1])
                    ).astype(np.int32)
    if bbox[2] - bbox[0] < 4 or bbox[3] - bbox[1] < 4:
        return None
    return bbox


def resize_square(rgb, size: int, device) -> torch.Tensor:
    """(H, W, 3) uint8 -> (size, size, 3) float32 in [0, 1] on ``device``,
    bilinear with antialiasing (``jax.image.resize`` "linear")."""
    img = torch.from_numpy(np.array(rgb, np.uint8)).to(device)
    img = img.to(torch.float32).permute(2, 0, 1)[None] / 255.0
    img = F.interpolate(img, size=(size, size), mode="bilinear",
                        antialias=True, align_corners=False)
    return img[0].permute(1, 2, 0)


class TorchDetector:
    """Runs :class:`~pix2pose_torch.models.detector.CenterNetDetector` and
    emits :class:`Detection` records with per-instance masks.

    ``state_dict`` (a converted checkpoint) is loaded strictly into
    ``model``, which is moved to ``device`` and put in eval mode."""

    def __init__(self, model, state_dict, class_to_obj_id,
                 score_th: float = 0.3, top_k: int = 32,
                 input_size: int = 512, device="cuda"):
        self.device = torch.device(device)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.class_to_obj_id = list(class_to_obj_id)
        self.score_th = score_th
        self.top_k = top_k
        self.input_size = input_size

    @torch.no_grad()
    def _run(self, rgb):
        img = resize_square(rgb, self.input_size, self.device)
        det = decode_detections(self.model(img[None]), top_k=self.top_k,
                                with_masks=True)
        return det._replace(**{k: v.cpu().numpy() for k, v in
                               det._asdict().items()})

    def detect(self, scene_id, im_id, rgb):
        from PIL import Image

        h, w = rgb.shape[:2]
        s = self.input_size
        det = self._run(rgb)
        sv, su = h / s, w / s  # square px -> image px
        out = []
        for i in range(det.score.shape[1]):
            sc = float(det.score[0, i])
            if sc < self.score_th:
                continue
            bbox = _frame_box(det.bbox[0, i], sv, su, h, w)
            if bbox is None:
                continue
            cls = int(det.cls[0, i])
            m_res = np.asarray(Image.fromarray(
                det.mask[0, i].astype(np.uint8) * 255).resize(
                (w, h), Image.BILINEAR)) > 127
            box_m = np.zeros((h, w), bool)
            box_m[bbox[0]:bbox[2] + 1, bbox[1]:bbox[3] + 1] = True
            out.append(Detection(bbox=bbox,
                                 obj_id=self.class_to_obj_id[cls],
                                 score=sc, mask=m_res & box_m))
        return out


class RetinaNetAdapter:
    """Detection protocol over :class:`~pix2pose_torch.models.retinanet.
    RetinaNetDetector` (the reference's keras-retinanet inference path,
    ``5_evaluation_bop_basic.py:83-97``): boxes and scores, and a
    box-shaped mask per detection. ``state_dict`` is loaded strictly into
    ``model``, which is moved to ``device`` and put in eval mode."""

    def __init__(self, model, state_dict, class_to_obj_id,
                 score_th: float = 0.3, top_k: int = 64,
                 input_size: int = 512, nms_iou: float = 0.5,
                 device="cuda"):
        from pix2pose_torch.models.retinanet import anchor_boxes

        self.device = torch.device(device)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.class_to_obj_id = list(class_to_obj_id)
        self.score_th = score_th
        self.top_k = top_k
        self.nms_iou = nms_iou
        self.input_size = input_size
        self.anchors = torch.as_tensor(anchor_boxes(input_size),
                                       device=self.device)

    @torch.no_grad()
    def _run(self, rgb):
        from pix2pose_torch.models.retinanet import decode_retinanet

        img = resize_square(rgb, self.input_size, self.device)
        out = decode_retinanet(self.model(img[None]), self.anchors,
                               top_k=self.top_k, nms_iou=self.nms_iou)
        return [t[0].cpu().numpy() for t in out]

    def detect(self, scene_id, im_id, rgb):
        h, w = rgb.shape[:2]
        s = self.input_size
        boxes, scores, cls = self._run(rgb)
        out = []
        for i in range(scores.shape[0]):
            sc = float(scores[i])
            if sc < self.score_th:
                continue
            bbox = _frame_box(boxes[i], h / s, w / s, h, w)
            if bbox is None:
                continue
            box_m = np.zeros((h, w), bool)
            box_m[bbox[0]:bbox[2] + 1, bbox[1]:bbox[3] + 1] = True
            out.append(Detection(bbox=bbox,
                                 obj_id=self.class_to_obj_id[int(cls[i])],
                                 score=sc, mask=box_m))
        return out
