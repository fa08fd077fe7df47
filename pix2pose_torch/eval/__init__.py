"""Evaluation loops (BOP RGB and RGB-D with ICP), the ICP refiners and
the BOP'19 pose-error metrics."""

from pix2pose_torch.eval.bop_eval import BopEvaluator  # noqa: F401
