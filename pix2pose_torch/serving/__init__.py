"""Streaming serving layer (the reference's ROS node)."""

from pix2pose_torch.serving.service import (PoseService,  # noqa: F401
                                            RosAdapter, ServingConfig)
from pix2pose_torch.serving.server import (BatchingFrontend,  # noqa: F401
                                           PoseClient, PoseServer)
