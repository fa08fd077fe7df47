"""Weight conversion, inference checkpoints and synthetic-scene helpers."""
