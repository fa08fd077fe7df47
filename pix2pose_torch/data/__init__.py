"""Dataset I/O: BOP layout, PLY meshes, mesh decimation and the synthetic
BOP-format dataset generator."""
