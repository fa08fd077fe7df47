"""Data-preparation and measurement tools: model colorizing,
training-pair and train-view rendering, and the rasterizer
microbenchmark. Each runs as ``python -m pix2pose_torch.tools.<name>``;
the first three also as ``python -m pix2pose_torch <command>``."""
