"""Scripts of the port: the counterparts of the repository's scripts/
that have TPU kernels (mosaic_spike)."""
