"""Batched two-stage inference engine, the detection record and the
CenterNet detector adapter (``inference.torch_detector``)."""

from pix2pose_torch.inference.detector import Detection  # noqa: F401
from pix2pose_torch.inference.engine import (  # noqa: F401
    PoseEstimate,
    Pix2PoseEstimator,
)
