"""Data-preparation and measurement tools: training-pair and train-view
rendering, and the rasterizer microbenchmark. Each runs as
``python -m pix2pose_torch.tools.<name>``."""
