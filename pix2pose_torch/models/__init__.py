"""Networks: the Pix2Pose generator (paper and ResNet-50 backbones), its
GAN discriminator, the ResNet-50 trunk and the CenterNet/CondInst
detector."""

from pix2pose_torch.models.ae import AutoEncoder, build_generator  # noqa: F401
from pix2pose_torch.models.detector import CenterNetDetector  # noqa: F401
from pix2pose_torch.models.discriminator import Discriminator  # noqa: F401
from pix2pose_torch.models.resnet50 import ResNet50Trunk  # noqa: F401
