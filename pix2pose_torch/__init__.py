"""pix2pose_torch — the Pix2Pose pipeline in PyTorch for NVIDIA Hopper.

A port of :mod:`pix2pose_tpu` (JAX/Pallas on a TPU) to PyTorch and CUDA.
Module names mirror the JAX package so each function has an obvious
counterpart; public functions keep its layouts (NHWC images, ``(..., 3, 3)``
rotations, millimetre translations, metre depth) so the two can be held
against each other on the same inputs.

What is ported so far: the serving CLI (``python -m pix2pose_torch serve``:
checkpoints from ``utils.checkpoint``, the CenterNet detector of
``models.detector`` behind ``inference.torch_detector``) over the RGB-D
serving path -- ``serving`` (TCP server, coalescing frontend,
:class:`~pix2pose_torch.serving.service.PoseService`) ->
``inference.engine`` (two-stage AE, paper or ResNet-50 backbone, +
PnP-RANSAC) -> ``eval.icp_refine`` (render + point-to-plane ICP) ->
``ops.rasterizer``, whose full-frame renders on a CUDA device run the
hand-written z-buffer kernel in ``csrc/rasterizer.cu`` -- the BOP
evaluation (``python -m pix2pose_torch eval`` / ``eval-icp`` /
``run-detector``: ``eval.bop_eval``, ``eval.bop_eval_icp`` and the
BOP'19 metrics of ``eval.metrics``, whose VSD renders run the same
kernel) and the training-data rendering tools (``data.synthetic_bop``,
``tools``).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
